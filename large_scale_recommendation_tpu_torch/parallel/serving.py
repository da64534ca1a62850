"""Top-K serving over a prepared catalog: the single-card part of
``large_scale_recommendation_tpu.parallel.serving``.

The JAX package row-shards the catalog over a device mesh; here the mesh
has one device (``n_dev = 1``), so a catalog is one unpadded table on the
card and each query chunk runs

    scores [chunk, n] = U_chunk @ Vᵀ   (f32 accumulate, TF32 off)
                        + item_w          (masked rows: DEAD_SLOT_OFFSET)
    scatter-min of the exclusion triple
    top-k in ``lax.top_k``'s order (score descending, lower row first)

A ``mesh`` other than ``None`` raises ``NotImplementedError`` (ROADMAP.md
queue A, item 5: the mesh).

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
import weakref

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.utils.metrics import (
    DEAD_SLOT_OFFSET,
    _ieee_f32,
    apply_exclusions,
    lax_top_k,
)

MESH_NOT_PORTED = ("mesh serving is not ported yet (ROADMAP.md queue A, "
                   "item 5: the mesh); pass mesh=None")

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


def _catalog_dtype(dtype) -> torch.dtype:
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
    f32 or bf16) and the phantom-row weights ``w_sh`` on the card.
    ``version`` is the ``catalog_version`` token of the source table at
    build time. With one device ``rows_per_shard == n_rows``."""

    V_sh: torch.Tensor  # [n_rows, r] f32 or bf16
    w_sh: torch.Tensor  # [n_rows] 0 real, DEAD_SLOT_OFFSET masked
    n_rows: int
    rows_per_shard: int
    version: int = 0
    dtype: str = "float32"

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
        V_new = self.V_sh.index_copy(
            0, torch.as_tensor(rows, dtype=torch.int64, device=dev), vals)
        return dataclasses.replace(
            self, V_sh=V_new,
            version=(catalog_version(V_new) if version is None
                     else version))


def shard_catalog(V: torch.Tensor, mesh=None, item_mask=None,
                  dtype=None) -> ShardedCatalog:
    """The catalog of table ``V`` on ``V``'s device, as its own copy in
    ``dtype`` (default f32; ``"bfloat16"`` stores it half-width, and its
    scores still accumulate in f32). ``item_mask`` (True = real item)
    gives masked rows ``DEAD_SLOT_OFFSET`` additively."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    cat_dtype = _catalog_dtype(dtype)
    n_rows = int(V.shape[0])
    item_w = np.zeros(n_rows, np.float32)
    if item_mask is not None:
        item_w[~np.asarray(item_mask, dtype=bool)] = DEAD_SLOT_OFFSET
    version = catalog_version(V)
    return ShardedCatalog(
        V_sh=V.to(cat_dtype, copy=True),
        w_sh=torch.from_numpy(item_w).to(V.device),
        n_rows=n_rows, rows_per_shard=n_rows, version=version,
        dtype=str(cat_dtype).split(".")[-1])


# --------------------------------------------------------------------------
# Scoring step (the one-device counterpart of _mesh_topk_step)
# --------------------------------------------------------------------------


def topk_step(U_chunk, V, item_w, excl_rows, excl_cols, excl_w, *,
              k_out: int):
    """Score one query chunk against the whole catalog and keep the top
    ``k_out``: one f32-accumulated ``U_chunk @ Vᵀ`` (bf16 operands are
    upcast first, TF32 off), ``+ item_w``, the exclusion triple
    scatter-min'ed, ``torch.topk`` in ``lax.top_k``'s order. Returns
    ``(values f32 [b, k_out], rows int64 [b, k_out])`` on the device, with
    no host read."""
    with _ieee_f32():
        scores = U_chunk.float() @ V.float().T
    scores += item_w
    apply_exclusions(scores, excl_rows, excl_cols, excl_w)
    return lax_top_k(scores, k_out)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array onto ``device`` without the host waiting on the card:
    staged through pinned memory and copied with ``non_blocking=True``
    (from pageable memory the copy would block the host behind every
    kernel already queued)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Readback:
    """A device→host copy started now and waited for later: on the card a
    ``non_blocking`` copy into pinned memory plus an event recorded after
    it, so waiting covers this chunk only, never the chunk queued
    behind it."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def run_pipelined_topk(user_rows, *, k: int, k_out: int, n_rows: int,
                       slice_size: int, bucket_fn, score_chunk,
                       on_batch=None):
    """The chunk loop of the serving engine: walk ``user_rows`` in
    ``slice_size`` slices, pad each to ``bucket_fn(len(slice))`` rows,
    score via ``score_chunk(cu_padded, c) -> (v_top, r_top)`` (device
    work only, no host read), and drain results ONE chunk behind the
    dispatch, so host work for chunk i+1 (exclusion building, staging)
    overlaps device scoring of chunk i. Each chunk's results are copied
    back asynchronously right after its own kernels; the drain waits for
    that copy alone. Ends with the pad-row clamp: rows ≥ ``n_rows`` (slab
    pads) become row 0 / -inf. ``on_batch(bucket)`` observes each
    dispatched bucket. Returns ``(rows int32 [n, k], scores f32 [n, k])``.
    """
    n = len(user_rows)
    out_rows = np.zeros((n, k), np.int32)
    out_scores = np.full((n, k), -np.inf, np.float32)
    if n == 0:
        return out_rows, out_scores
    pending = None  # (c0, c, values readback, rows readback)

    def drain(p):
        p0, pc, pv, pr = p
        out_rows[p0:p0 + pc, :k_out] = pr.numpy()[:pc]
        out_scores[p0:p0 + pc, :k_out] = pv.numpy()[:pc]

    for c0 in range(0, n, slice_size):
        cu = user_rows[c0:c0 + slice_size]
        c = len(cu)
        bucket = bucket_fn(c)
        if c < bucket:
            cu = np.concatenate([cu, np.zeros(bucket - c, cu.dtype)])
        v_top, r_top = score_chunk(cu, c)
        current = (c0, c, _Readback(v_top), _Readback(r_top))
        if on_batch is not None:
            on_batch(bucket)
        if pending is not None:
            drain(pending)
        pending = current
    drain(pending)
    pad_hits = out_rows >= n_rows  # surfaced padding rows
    out_rows[pad_hits] = 0
    out_scores[pad_hits] = -np.inf
    return out_rows, out_scores
