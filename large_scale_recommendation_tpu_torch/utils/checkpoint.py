"""Checkpoint / resume: durable snapshots of factor tables + step counters
(counterpart of ``large_scale_recommendation_tpu.utils.checkpoint``; the
files are the same format, so either package restores what the other
wrote).

Format: one ``ckpt_<step>.npz`` per step, written to a temporary file and
``os.replace``d into place, with keep-last-k retention. The entry
``__meta__`` holds the meta dict as json bytes; bf16 arrays are stored as
their uint16 bit view, tagged in the meta's ``__dtypes__``.

Mesh tables (``ShardedCheckpointManager``): each rank writes only its own
pieces, ``ckpt_<step>.shard<rank>of<world>.npz`` (each piece's row and
column offsets and its data), and rank 0 writes
``ckpt_<step>.manifest.json`` once every rank has written. Restore
reassembles each rank's slice from whichever pieces cover it, so a resume
on another grid (a changed ``model_parallel``) re-shards. The JAX package
writes one file per process, holding each of its devices' pieces; either
package restores the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.obs.transfers import get_transfers
from large_scale_recommendation_tpu_torch.parallel.partitioner import _world
from large_scale_recommendation_tpu_torch.utils.device import resolve_device


def _encode_array(v) -> tuple[np.ndarray, str | None]:
    """(savez-safe numpy array, dtype tag or None) of a numpy array or a
    torch tensor on any device. A bf16 tensor, or a numpy array whose
    dtype is named ``bfloat16``, becomes its uint16 bit view."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, None


def _decode_array(a: np.ndarray, tag: str | None):
    if not tag:
        return a
    if tag != "bfloat16":
        raise ValueError(f"checkpoint dtype tag {tag!r} unsupported")
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """One restored snapshot. ``arrays`` holds numpy arrays, except that an
    entry saved as bf16 comes back as a CPU ``torch.bfloat16`` tensor
    (numpy has no bf16 dtype without ``ml_dtypes``)."""

    step: int
    arrays: dict
    meta: dict

    def __getitem__(self, k: str):
        return self.arrays[k]


class CheckpointManager:
    """Directory of step-stamped snapshots with keep-last-k retention."""

    _FILE = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    # -- write ---------------------------------------------------------------

    def save(self, step: int, arrays: dict, meta: dict | None = None) -> str:
        """Atomic snapshot (temporary file + rename), then the retention
        sweep. Values are numpy arrays or tensors on any device; bf16 ones
        round-trip exactly through their bit view."""
        payload = {}
        dtype_tags: dict[str, str] = {}
        for k, v in arrays.items():
            payload[k], tag = _encode_array(v)
            if tag:
                dtype_tags[k] = tag
        meta = dict(meta or {})
        if dtype_tags:
            meta["__dtypes__"] = dtype_tags
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8)
        path = self.path(step)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._retain()
        return path

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.unlink(self.path(s))
            except FileNotFoundError:
                pass  # another writer's sweep already retired it

    # -- read ----------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = self._FILE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> Checkpoint:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        with np.load(self.path(step)) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = (json.loads(z["__meta__"].tobytes().decode())
                    if "__meta__" in z.files else {})
        tags = meta.pop("__dtypes__", {})
        arrays = {k: _decode_array(v, tags.get(k)) for k, v in arrays.items()}
        return Checkpoint(step=step, arrays=arrays, meta=meta)


def _tensor(a) -> torch.Tensor:
    """A restored entry (numpy, or a bf16 tensor) as a CPU tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


def restore_segment_state(manager: CheckpointManager, kind: str, U, V):
    """Resume helper of the DSGD segment loop: the latest snapshot as
    ``(U, V, done)``, the tables cast to ``U``/``V``'s dtype on their
    device. Returns the inputs with ``done=0`` when there is no snapshot.

    Refuses a snapshot of another fit path (``kind``): host-blocked (fit)
    and device-blocked (fit_device) layouts put ids on different rows of
    tables of the same shape. Refuses a shape mismatch too."""
    latest = manager.latest_step()
    if latest is None:
        return U, V, 0
    ck = manager.restore(latest)
    ck_kind = ck.meta.get("kind")
    if ck_kind != kind:
        raise ValueError(
            f"checkpoint kind {ck_kind!r} does not match this fit path "
            f"({kind!r}) — host-blocked (fit) and device-blocked "
            "(fit_device) row layouts are incompatible")
    if (tuple(ck["U"].shape) != tuple(U.shape)
            or tuple(ck["V"].shape) != tuple(V.shape)):
        raise ValueError(
            "checkpoint shape mismatch — resumed fit must use the same "
            "ratings, seed, rank and block count")
    return (_tensor(ck["U"]).to(device=U.device, dtype=U.dtype),
            _tensor(ck["V"]).to(device=V.device, dtype=V.dtype), latest)


# -- sharded (mesh) checkpoints -----------------------------------------------


def _write_atomic(directory: str, name: str, write) -> None:
    """``write(file)`` into a temporary file, renamed to ``name``."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, os.path.join(directory, name))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _dtype_name(v) -> str:
    dt = v.dtype
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else \
        np.dtype(dt).name


class ShardedCheckpointManager:
    """Per-rank snapshots of mesh-sharded tables: no rank gathers a whole
    table to save it. A checkpoint is complete once its manifest and every
    shard file it names exist.

    Needs a directory that every rank sees (the JAX package's assumption
    too). ``save`` is collective when the process group has more than one
    rank: one barrier orders the manifest after every shard, and a second
    one holds every rank until the manifest and retention are done."""

    _MANIFEST = re.compile(r"^ckpt_(\d+)\.manifest\.json$")
    _SHARD = re.compile(
        r"^ckpt_(\d+)\.(?:manifest\.json|shard\d+of\d+\.npz)$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, arrays: dict, meta: dict | None = None) -> str:
        """Write this rank's pieces (+ the manifest on rank 0), then sweep
        retention. A value is a ``parallel.partitioner.LocalShard`` (this
        rank's piece, its offset and the whole shape: ``Partitioner
        .local_shard``) or a whole array (numpy or tensor, offset 0)."""
        world, rank = _world()
        payload: dict[str, np.ndarray] = {}
        shapes = {}
        for key, v in arrays.items():
            if hasattr(v, "offset"):
                data, (r0, c0), shape = v.data, v.offset, tuple(v.shape)
            else:
                data, r0, c0, shape = v, 0, 0, tuple(v.shape)
            shapes[key] = {"shape": [int(d) for d in shape],
                           "dtype": _dtype_name(data)}
            payload[f"{key}__starts"] = np.asarray([r0], np.int64)
            payload[f"{key}__lens"] = np.asarray([data.shape[0]], np.int64)
            if len(shape) > 1 and (c0 != 0 or data.shape[1] != shape[1]):
                # column offsets only where the columns are split (the
                # rank-sharded layout); whole-width pieces carry none
                payload[f"{key}__cstarts"] = np.asarray([c0], np.int64)
                payload[f"{key}__clens"] = np.asarray([data.shape[1]],
                                                      np.int64)
            payload[f"{key}__p0"], _ = _encode_array(data)
        shard_name = f"ckpt_{step}.shard{rank}of{world}.npz"
        _write_atomic(self.directory, shard_name,
                      lambda f: np.savez(f, **payload))
        if world > 1:
            dist.barrier()  # the manifest names only shards on disk
        if rank == 0:
            manifest = {
                "step": step, "nproc": world,
                "shards": [f"ckpt_{step}.shard{p}of{world}.npz"
                           for p in range(world)],
                "arrays": shapes, "meta": meta or {}}
            _write_atomic(self.directory, f"ckpt_{step}.manifest.json",
                          lambda f: f.write(json.dumps(manifest).encode()))
            self._retain()
        if world > 1:
            dist.barrier()  # no rank reads the directory before it is done
        return shard_name

    def _retain(self) -> None:
        steps = self.steps()
        retire = set(steps[: max(0, len(steps) - self.keep)])
        for name in os.listdir(self.directory):
            m = self._SHARD.match(name)
            # this manager's file kinds only: a bare ckpt_<s>.npz is a
            # single-process snapshot and survives
            if m and int(m.group(1)) in retire:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except FileNotFoundError:
                    pass

    # -- read ----------------------------------------------------------------

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory,
                               f"ckpt_{step}.manifest.json")) as f:
            return json.load(f)

    def _is_complete(self, step: int) -> bool:
        try:
            m = self._manifest(step)
        except (OSError, json.JSONDecodeError):
            return False
        return all(os.path.exists(os.path.join(self.directory, s))
                   for s in m["shards"])

    def _manifest_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            self._MANIFEST.match, os.listdir(self.directory)) if m)

    def steps(self) -> list[int]:
        return [s for s in self._manifest_steps() if self._is_complete(s)]

    def incomplete_steps(self) -> list[int]:
        """Manifests whose shard files are missing (a crashed save)."""
        return [s for s in self._manifest_steps()
                if not self._is_complete(s)]

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def meta(self, step: int) -> dict:
        return self._manifest(step).get("meta", {})

    def restore_array(self, step: int, key: str, partitioner, shape, dtype,
                      *logical: str | None) -> torch.Tensor:
        """This rank's slice (``partitioner.place`` of the whole array laid
        out as ``logical``) of array ``key``, in ``dtype`` on the
        partitioner's device. Only the pieces that overlap the slice are
        read; a slice the pieces do not cover raises."""
        m = self._manifest(step)
        want = m["arrays"].get(key)
        if want is None:
            raise KeyError(f"checkpoint step {step} has no array {key!r}")
        if tuple(want["shape"]) != tuple(shape):
            raise ValueError(
                f"checkpoint {key} shape {want['shape']} != {list(shape)} — "
                "resumed fit must use the same ratings, seed, rank and "
                "block count")
        rng = partitioner.local_range(shape, *logical)
        (r0, r1) = rng[0]
        (c0, c1) = rng[1] if len(shape) > 1 else (0, 1)
        ncols = int(shape[1]) if len(shape) > 1 else 1
        tag = "bfloat16" if want["dtype"] == "bfloat16" else None
        out = torch.empty((r1 - r0, c1 - c0), dtype=dtype)
        filled = 0
        seen = set()  # (row, column) starts: duplicated pieces count once
        for name in m["shards"]:
            with np.load(os.path.join(self.directory, name)) as z:
                if f"{key}__starts" not in z.files:
                    continue
                starts, lens = z[f"{key}__starts"], z[f"{key}__lens"]
                if f"{key}__cstarts" in z.files:
                    cstarts, clens = z[f"{key}__cstarts"], z[f"{key}__clens"]
                else:
                    cstarts = np.zeros(len(starts), np.int64)
                    clens = np.full(len(starts), ncols, np.int64)
                for j, (s, ln, cs, cl) in enumerate(
                        zip(starts, lens, cstarts, clens)):
                    s, ln, cs, cl = int(s), int(ln), int(cs), int(cl)
                    lo, hi = max(s, r0), min(s + ln, r1)
                    clo, chi = max(cs, c0), min(cs + cl, c1)
                    if (s, cs) in seen or lo >= hi or clo >= chi:
                        continue
                    seen.add((s, cs))
                    piece = _tensor(_decode_array(z[f"{key}__p{j}"], tag))
                    piece = piece.reshape(ln, -1)
                    out[lo - r0:hi - r0, clo - c0:chi - c0] = \
                        piece[lo - s:hi - s, clo - cs:chi - cs].to(dtype)
                    filled += (hi - lo) * (chi - clo)
        if filled < (r1 - r0) * (c1 - c0):
            raise ValueError(
                f"checkpoint step {step} is missing rows [{r0},{r1}) × cols "
                f"[{c0},{c1}) of {key} — shard layout mismatch")
        if len(shape) < 2:
            out = out[:, 0]
        return out.to(partitioner.device)


def restore_segment_state_sharded(manager: ShardedCheckpointManager,
                                  kind: str, U, V, partitioner):
    """Mesh twin of ``restore_segment_state``: the latest snapshot as this
    rank's ``(U, V, done)`` slices (U as ``('users', 'rank')``, V as
    ``('items', 'rank')``) in ``U``/``V``'s dtype on the partitioner's
    device. ``U``/``V`` are the whole initial tables: without a snapshot
    their slices come back with ``done=0``; with one only their shape and
    dtype are read. The same refusal of another fit path's snapshot; a
    newer manifest with missing shards is a crashed save and warns."""
    latest = manager.latest_step()
    broken = [s for s in manager.incomplete_steps()
              if latest is None or s > latest]
    if broken:
        warnings.warn(
            f"{manager.directory} holds incomplete checkpoint(s) at "
            f"step(s) {broken} (manifest present, shard files missing — "
            f"crashed save?); resuming from "
            f"{'scratch' if latest is None else f'step {latest}'} instead",
            RuntimeWarning, stacklevel=2)
    if latest is None:
        legacy = [n for n in os.listdir(manager.directory)
                  if CheckpointManager._FILE.match(n)]
        if legacy:
            raise ValueError(
                f"{manager.directory} holds single-process checkpoints "
                f"({legacy[:3]}...) but no sharded manifest; restore them "
                "with CheckpointManager.restore() and re-save, or point "
                "the sharded manager at a fresh directory")
        return (partitioner.place(U, "users", "rank"),
                partitioner.place(V, "items", "rank"), 0)
    ck_kind = manager.meta(latest).get("kind")
    if ck_kind != kind:
        raise ValueError(
            f"checkpoint kind {ck_kind!r} does not match this fit path "
            f"({kind!r}) — host-blocked (fit) and device-blocked "
            "(fit_device) row layouts are incompatible")
    return (manager.restore_array(latest, "U", partitioner, tuple(U.shape),
                                  U.dtype, "users", "rank"),
            manager.restore_array(latest, "V", partitioner, tuple(V.shape),
                                  V.dtype, "items", "rank"), latest)


def save_mf_model(manager: CheckpointManager, model: MFModel, step: int,
                  extra_meta: dict | None = None) -> str:
    """Snapshot an ``MFModel`` (factors + id layouts)."""
    meta = {"kind": "mf_model", "rank": model.rank}
    meta.update(extra_meta or {})
    return manager.save(step, {
        "U": model.U,
        "V": model.V,
        "user_ids": model.users.ids,
        "item_ids": model.items.ids,
        "user_omega": model.users.omega,
        "item_omega": model.items.omega,
        "user_blocks": np.asarray([model.users.num_blocks,
                                   model.users.rows_per_block]),
        "item_blocks": np.asarray([model.items.num_blocks,
                                   model.items.rows_per_block]),
    }, meta)


def restore_mf_model(manager: CheckpointManager, step: int | None = None,
                     device=None) -> tuple[MFModel, Checkpoint]:
    """Rebuild an ``MFModel`` from a snapshot, its tables on ``device``
    (``None``: the card)."""
    dev = resolve_device(device)
    ck = manager.restore(step)

    def index(ids, omega, blocks):
        ids = ids.astype(np.int64)
        real = ids >= 0
        rows = np.nonzero(real)[0]
        order = np.argsort(ids[real])
        return IdIndex(ids=ids, num_blocks=int(blocks[0]),
                       rows_per_block=int(blocks[1]),
                       omega=omega.astype(np.float32),
                       sorted_ids=ids[real][order],
                       sorted_rows=rows[order])

    model = MFModel(
        U=_tensor(ck["U"]).to(dev), V=_tensor(ck["V"]).to(dev),
        users=index(ck["user_ids"], ck["user_omega"], ck["user_blocks"]),
        items=index(ck["item_ids"], ck["item_omega"], ck["item_blocks"]))
    return model, ck


def snapshot_online_state(online) -> tuple[dict, dict]:
    """One consistent ``(arrays, meta)`` view of an ``OnlineMF``: the id
    layouts (host copies), the registered rows of both tables (views: the
    tables are never written in place; a tiered store's merged host copy),
    the step and the consumed stream offsets. A tiered store's resident
    rows ride along as ``user_hot_rows`` / ``item_hot_rows``, so a restart
    re-warms the hot tier it stopped with."""
    u_ids = np.asarray(online.users.id_array(), dtype=np.int64)
    i_ids = np.asarray(online.items.id_array(), dtype=np.int64)
    meta = {"kind": "online_state", "step": int(online.step),
            "offsets": {str(k): int(v)
                        for k, v in online.consumed_offsets.items()}}
    ledger = get_transfers()
    t0 = time.perf_counter() if ledger is not None else 0.0
    U = online.users.snapshot_rows(len(u_ids))
    V = online.items.snapshot_rows(len(i_ids))
    if ledger is not None:  # the snapshot's rows leave the card for the file
        ledger.note_transfer("checkpoint.snapshot", "d2h",
                             int(U.nbytes) + int(V.nbytes),
                             time.perf_counter() - t0)
    arrays = {"user_ids": u_ids, "item_ids": i_ids, "U": U, "V": V}
    for key, table in (("user_hot_rows", online.users),
                       ("item_hot_rows", online.items)):
        resident = getattr(table, "resident_rows", None)
        if resident is not None:
            arrays[key] = np.asarray(resident(), dtype=np.int64)
    return arrays, meta


def save_online_state(manager: CheckpointManager, online, step: int,
                      extra_meta: dict | None = None) -> str:
    """Snapshot an ``OnlineMF``'s tables (ids + factors) with its step and
    consumed stream offsets, in one file: factors and stream position are
    one atomic snapshot. JSON makes the offset keys strings; restore
    converts them back."""
    arrays, meta = snapshot_online_state(online)
    meta.update(extra_meta or {})
    return manager.save(step, arrays, meta)


def restore_online_state(manager: CheckpointManager, online,
                         step: int | None = None) -> Checkpoint:
    """Load a snapshot into an ``OnlineMF``: ids are registered in saved
    order (so rows are assigned as they were), then the saved rows are
    written, on the model's device; step and offsets are restored. A
    tiered store re-warms the snapshot's resident rows when the file has
    them. Returns the ``Checkpoint``."""
    ck = manager.restore(step)
    for key_ids, key_arr, key_hot, table in (
            ("user_ids", "U", "user_hot_rows", online.users),
            ("item_ids", "V", "item_hot_rows", online.items)):
        ids = ck[key_ids]
        if len(ids) == 0:
            continue
        rows = table.ensure(ids)
        ledger = get_transfers()
        t0 = time.perf_counter() if ledger is not None else 0.0
        table.load_rows(rows, ck[key_arr])
        if ledger is not None:  # the restored rows go back to the card
            ledger.note_transfer("checkpoint.restore", "h2d",
                                 int(ck[key_arr].nbytes),
                                 time.perf_counter() - t0)
        warm = getattr(table, "warm_rows", None)
        if warm is not None and key_hot in ck.arrays:
            warm(ck[key_hot])
    online.step = int(ck.meta.get("step", 0))
    online.consumed_offsets = {
        int(k): int(v) for k, v in ck.meta.get("offsets", {}).items()}
    return ck
