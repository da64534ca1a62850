"""Catalogs and top-K over a mesh (counterpart of
``large_scale_recommendation_tpu.parallel.serving``).

Without a mesh a catalog is one unpadded table on the caller's device,
scored by ``ops.topk.topk_step`` (the port's one top-K contract: score
surface, exclusions, ``lax.top_k`` order, chunk loop and row → id map
live there). Over a mesh (a ``Partitioner``) the catalog is padded to a
multiple of the data ring's size k and each rank holds its rows
(``'items'``) and, with ``model_parallel > 1``, its columns (``'rank'``)
of it. Every rank scores its rows (a rank-sharded rank sums its partial
product over the model group first), applies the exclusions that fall in
its range and keeps a local top-k; the ``[chunk, k]`` candidates are
gathered over the ring and merged by one more top-k (exact: the global
top-k is a subset of the local ones). Padding rows score -inf and come
back as row 0 / -inf.

Catalogs are VERSIONED (``catalog_version``) so a serving cache can tell a
retrain swap with one integer compare. A JAX array is immutable, so the
JAX package keys the token on the array object alone; a torch tensor can
change in place (the DSGD kernels and ``index_copy_`` write tables in
place), so the token here is keyed on the object AND its in-place counter
``tensor._version``: a table modified in place gets a fresh token, and
every catalog built here owns copies of its tables, so a live catalog
never changes under its version.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.obs.budget import get_budget
from large_scale_recommendation_tpu_torch.obs.requests import get_requests
from large_scale_recommendation_tpu_torch.ops.topk import (
    apply_exclusions,
    exclusion_builder,
    ieee_f32,
    item_weights,
    lax_top_k,
    run_pipelined_topk,
    to_device,
)
from large_scale_recommendation_tpu_torch.parallel import collectives
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    as_partitioner,
)
from large_scale_recommendation_tpu_torch.utils.shapes import pow2_pad

# --------------------------------------------------------------------------
# Catalog versioning
# --------------------------------------------------------------------------

_version_counter = itertools.count(1)
_versions_by_id: dict[int, tuple] = {}  # id → (in-place counter, token)
_versions_lock = threading.Lock()  # serving and retrain threads both stamp


def catalog_version(V) -> int:
    """A token identifying THIS factor table in its current contents.

    Stable while the object lives unmodified (repeated calls return the
    same token); a new object, or the same tensor after an in-place write
    (its ``_version`` moved), gets a fresh token. A weakref finalizer
    retires the entry with the object, so a reused ``id`` never inherits a
    token."""
    key = id(V)
    counter = getattr(V, "_version", None)
    with _versions_lock:
        entry = _versions_by_id.get(key)
        if entry is not None and entry[0] == counter:
            return entry[1]
        tok = next(_version_counter)
        if entry is None:
            try:
                weakref.finalize(V, _versions_by_id.pop, key, None)
            except TypeError:
                return tok  # not weakref-able: never memoized
        _versions_by_id[key] = (counter, tok)
    return tok


def catalog_dtype(dtype) -> torch.dtype:
    """A catalog's storage dtype: float32 (the default) or bfloat16."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
            str(dtype))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"catalog dtype must be float32 or bfloat16, "
                         f"got {dtype!r}")
    return out


# --------------------------------------------------------------------------
# Catalog
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedCatalog:
    """A catalog prepared for serving: the factor table (its own copy,
    f32 or bf16) and the phantom-row weights ``w_sh`` on the device.
    ``version`` is the ``catalog_version`` token of the source table at
    build time. Without a mesh ``rows_per_shard == n_rows``; over one
    (``partitioner``) ``V_sh``/``w_sh`` are this rank's slice of the padded
    table: rows ``[p·rows_per_shard, (p+1)·rows_per_shard)`` (p its data
    index) and, rank-sharded, its columns."""

    V_sh: torch.Tensor  # [rows_per_shard, r / m] f32 or bf16
    w_sh: torch.Tensor  # [rows_per_shard] 0 real, DEAD_SLOT_OFFSET masked,
    #                     -inf mesh padding
    n_rows: int
    rows_per_shard: int
    version: int = 0
    dtype: str = "float32"
    partitioner: object = None

    def apply_delta(self, rows, values,
                    version: int | None = None) -> "ShardedCatalog":
        """Install ONLY the given catalog rows, out of place (a new table;
        the old catalog stays as it was), cast to the catalog dtype as a
        build casts: bit-equal to rebuilding from the patched table.
        ``version`` defaults to a fresh token of the new table."""
        rows = np.asarray(rows)
        if len(rows) == 0:
            return dataclasses.replace(
                self, version=(catalog_version(self.V_sh) if version is None
                               else version))
        dev = self.V_sh.device
        vals = torch.as_tensor(values).to(dev).to(self.V_sh.dtype)
        part = self.partitioner
        if part is not None:  # the rows and columns of this rank's slice
            base = part.data.index * self.rows_per_shard
            mine = (rows >= base) & (rows < base + self.rows_per_shard)
            rows = rows[mine] - base
            vals = part.rank_slice(vals[torch.as_tensor(mine, device=dev)])
        V_new = self.V_sh.index_copy(
            0, torch.as_tensor(rows, dtype=torch.int64, device=dev), vals)
        return dataclasses.replace(
            self, V_sh=V_new,
            version=(catalog_version(V_new) if version is None
                     else version))


def shard_catalog(V: torch.Tensor, mesh=None, item_mask=None,
                  dtype=None) -> ShardedCatalog:
    """The catalog of the whole table ``V``, as its own copy in ``dtype``
    (default f32; ``"bfloat16"`` stores it half-width, and its scores
    still accumulate in f32). ``item_mask`` (True = real item) gives
    masked rows ``DEAD_SLOT_OFFSET`` additively.

    ``mesh=None``: one table on ``V``'s device. A ``Partitioner``: ``V``
    (the whole table on every rank) is padded to a multiple of the ring's
    size and this rank keeps its slice, on the partitioner's device."""
    cat_dtype = catalog_dtype(dtype)
    n_rows = int(V.shape[0])
    item_w = item_weights(n_rows, item_mask)
    version = catalog_version(V)
    name = str(cat_dtype).split(".")[-1]
    if mesh is None:
        return ShardedCatalog(
            V_sh=V.to(cat_dtype, copy=True),
            w_sh=torch.from_numpy(item_w).to(V.device),
            n_rows=n_rows, rows_per_shard=n_rows, version=version,
            dtype=name)
    part = as_partitioner(mesh)
    part.require_rank_divisible(int(V.shape[1]), "shard_catalog")
    k = part.num_blocks
    rpb = -(-n_rows // k)
    # mesh padding scores -inf, below even excluded or masked rows
    item_w = np.concatenate([item_w, np.full(k * rpb - n_rows, -np.inf,
                                             np.float32)])
    V_pad = torch.zeros((k * rpb, V.shape[1]), dtype=cat_dtype,
                        device=V.device)
    V_pad[:n_rows] = V.detach().to(cat_dtype)
    return ShardedCatalog(
        V_sh=part.place(V_pad, "items", "rank"),
        w_sh=part.place(item_w, "items"), n_rows=n_rows,
        rows_per_shard=rpb, version=version, dtype=name, partitioner=part)


def catalog_from_shard(V_local: torch.Tensor, partitioner, item_mask=None,
                       dtype=None) -> ShardedCatalog:
    """The catalog of a table that already lies sharded as ``('items',
    'rank')`` (a ``ShardedMFModel``'s V: its height divides over the ring,
    so there is no padding): this rank's shard, cast to ``dtype``, with no
    table gathered. ``item_mask`` covers the whole table."""
    part = partitioner
    cat_dtype = catalog_dtype(dtype)
    rpb = int(V_local.shape[0])
    n_rows = rpb * part.num_blocks
    item_w = item_weights(n_rows, item_mask)
    return ShardedCatalog(
        V_sh=V_local.to(cat_dtype, copy=True),
        w_sh=part.place(item_w, "items"), n_rows=n_rows,
        rows_per_shard=rpb, version=catalog_version(V_local),
        dtype=str(cat_dtype).split(".")[-1], partitioner=part)


# --------------------------------------------------------------------------
# Top-K over the mesh
# --------------------------------------------------------------------------


def mesh_topk_step(part, U_chunk, V_l, w_l, excl_rows, excl_cols, excl_w,
                   *, k_local: int, k_out: int, rows_per_shard: int):
    """One query chunk on one rank of the mesh (``_mesh_topk_step``'s
    body): score the rank's rows (rank-sharded: the chunk's column slice,
    the partial product summed over the model group), apply the exclusions
    in its row range, keep ``k_local``, gather every rank's candidates
    over the ring and keep ``k_out``. ``U_chunk`` holds full rows on every
    rank; the exclusions carry global item rows. Returns ``(values f32
    [b, k_out], global rows int64 [b, k_out])`` on the device."""
    data = part.data
    with ieee_f32():
        scores = collectives.group_sum(
            part.model, part.rank_slice(U_chunk).float() @ V_l.float().T)
    scores += w_l
    base = data.index * rows_per_shard
    local = excl_cols.long() - base
    in_range = (local >= 0) & (local < rows_per_shard)
    w = torch.where(in_range, excl_w, torch.full_like(excl_w, np.inf))
    apply_exclusions(scores, excl_rows, local.clamp(0, rows_per_shard - 1),
                     w)
    v_loc, r_loc = lax_top_k(scores, k_local)
    v_all = collectives.gather(data, v_loc, dim=1)
    r_all = collectives.gather(data, r_loc + base, dim=1)
    v_top, pos = lax_top_k(v_all, k_out)
    return v_top, r_all.gather(1, pos)


def mesh_supports_donation(mesh) -> bool:
    """Whether a mesh's devices can reuse the per-call buffers (the JAX
    package gates its buffer donation on it): True on cards. The port has
    no donation; PyTorch's caching allocator reuses the chunk buffers."""
    return mesh.device.type == "cuda"


def mesh_top_k_recommend(U, V, user_rows, k: int = 10, train_u=None,
                         train_i=None, chunk: int = 2048, item_mask=None,
                         mesh=None, catalog: ShardedCatalog | None = None):
    """Row-space top-K over a sharded catalog, with the contract of
    ``utils.metrics.top_k_recommend``: inputs are row indices, the result
    is ``(top_rows int32 [n, k], top_scores f32 [n, k])`` as numpy on
    every rank. Collective: every rank calls it with the same arguments.

    ``U`` is the whole query table on every rank. Pass a prebuilt
    ``catalog`` (``shard_catalog``) to reuse it across calls; else it is
    built from ``V``, ``mesh`` and ``item_mask``. The chunk loop runs two
    deep (``run_pipelined_topk``): chunk i+1's exclusions are built on the
    host while chunk i is scored.

    With the rollout or request plane installed the call is noted as one
    request served by ``catalog.version`` (the bare mesh path has no engine
    flush to note it): its wall lands in the version's cohort, and its
    stage ledger marks the engine's seams (the residual, the pad clamp
    after the last drain, lands in ``topk_merge``)."""
    budget = get_budget()
    rt = get_requests()
    t_serve = (time.perf_counter()
               if budget is not None or rt is not None else 0.0)
    led = rt.ledger(t_serve) if rt is not None else None
    if catalog is None:
        catalog = shard_catalog(V, mesh, item_mask)
    part = catalog.partitioner
    if part is None:
        raise ValueError("mesh_top_k_recommend needs a mesh catalog: pass "
                         "mesh= or a catalog built with one")
    n_rows, rpb = catalog.n_rows, catalog.rows_per_shard
    user_rows = np.asarray(user_rows)
    n = len(user_rows)
    if n == 0:
        return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
    k_local = min(k, rpb)
    k_out = min(k, part.num_blocks * k_local)
    build_excl = exclusion_builder(train_u, train_i, int(U.shape[0]))
    dev = catalog.V_sh.device
    U_dev = U.to(dev)
    cat_dtype = catalog.V_sh.dtype

    def score_chunk(cu, c):
        excl = [to_device(a, dev) for a in build_excl(cu, c)]
        if led is not None:
            led.mark("batch_form")  # exclusion build + staging
        rows = to_device(np.asarray(cu, np.int64), dev)
        U_chunk = U_dev[rows].to(cat_dtype)
        if led is not None:
            led.mark("gather")
        out = mesh_topk_step(part, U_chunk, catalog.V_sh, catalog.w_sh,
                             *excl, k_local=k_local, k_out=k_out,
                             rows_per_shard=rpb)
        if led is not None:
            led.mark("score_stage1")  # one score dispatch: stage 1
        return out

    chunk = min(chunk, pow2_pad(n))
    out = run_pipelined_topk(
        user_rows, k=k, k_out=k_out, n_rows=n_rows, slice_size=chunk,
        bucket_fn=lambda c: chunk, score_chunk=score_chunk,
        on_drain=(None if led is None
                  else lambda: led.mark("topk_merge")))
    if budget is not None or led is not None:
        t_end = time.perf_counter()  # one read shared by both planes
        if budget is not None:
            budget.note_result(catalog.version, t_end - t_serve)
        if led is not None:
            rt.note_flush(led, t_end, (t_serve,), version=catalog.version,
                          rows=(n,), residual_stage="topk_merge")
    return out
