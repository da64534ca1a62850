"""The port's one top-K contract, for the serving engine, the mesh,
``MFModel.recommend`` / ``recommend_users`` and the ranking metrics. Per
query chunk: ``U_chunk @ Vᵀ`` in IEEE f32 (bf16 rows upcast, never
rounded back, as XLA's fused product) ``+ item_w`` (masked rows
``DEAD_SLOT_OFFSET``), the pow2-padded exclusion triple scatter-min'ed,
then ``lax.top_k``'s order. Chunks run two deep (``run_pipelined_topk``);
results are row space, or id space with dead slots, pad rows and slots
past the catalog as -1 / 0.0 (``ids_of_top``); unknown queries answer
-1 / 0.0 rows (``fill_unknown``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.utils.shapes import pow2_pad

# The dead-slot sentinel: excluded or masked catalog slots get
# DEAD_SLOT_OFFSET (scatter-min for exclusions, added for masked rows), so
# a surfaced dead slot scores near the offset; consumers classify by
# ``score > DEAD_SLOT_THRESHOLD``.
DEAD_SLOT_OFFSET = -1e30
DEAD_SLOT_THRESHOLD = -1e29


@contextlib.contextmanager
def ieee_f32():
    """f32 matmuls in IEEE f32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def item_weights(n_rows: int, item_mask) -> np.ndarray:
    """The catalog's additive row weights: 0 for a real item,
    ``DEAD_SLOT_OFFSET`` where ``item_mask`` is False."""
    item_w = np.zeros(n_rows, np.float32)
    if item_mask is not None:
        item_w[~np.asarray(item_mask, dtype=bool)] = DEAD_SLOT_OFFSET
    return item_w


def exclusion_builder(train_u, train_i, num_users: int):
    """Per-chunk train-seen exclusion lists, pow2-padded.

    Returns ``build(cu, c) -> (excl_rows, excl_cols, excl_w)`` (int32,
    int32, float32 numpy, one length, a power of two ≥ 8) for a padded
    chunk ``cu`` of user rows whose first ``c`` are real: entry j excludes
    item row ``excl_cols[j]`` for chunk position ``excl_rows[j]`` with
    weight ``DEAD_SLOT_OFFSET``; pads are ``(0, 0, +inf)``, no-ops under a
    scatter-min, and are told apart from real entries by ``excl_w < 0``."""
    if train_u is None:
        ep = pow2_pad(1)  # the same padded shape as an empty train slice

        def build_empty(cu, c):
            z = np.zeros(ep, np.int32)
            return z, z, np.full(ep, np.inf, np.float32)

        return build_empty

    train_u = np.asarray(train_u, dtype=np.int64)
    order = np.argsort(train_u, kind="stable")
    tu = train_u[order]
    ti = np.asarray(train_i, dtype=np.int32)[order]
    starts = np.searchsorted(tu, np.arange(num_users + 1))

    def build(cu, c):
        cu = np.asarray(cu, dtype=np.int64)
        counts = (starts[cu + 1] - starts[cu])[:c]
        e = int(counts.sum())
        rows = np.repeat(np.arange(c, dtype=np.int32), counts)
        # absolute positions of each user's train slice, vectorized
        offs = np.repeat(
            starts[cu[:c]] - np.concatenate([[0], np.cumsum(counts)[:-1]]),
            counts)
        cols = ti[np.arange(e) + offs] if e else np.zeros(0, np.int32)
        ep = pow2_pad(max(e, 1))
        excl_rows = np.zeros(ep, np.int32)
        excl_cols = np.zeros(ep, np.int32)
        excl_w = np.full(ep, np.inf, np.float32)  # pads: min() no-ops
        excl_rows[:e], excl_cols[:e], excl_w[:e] = (
            rows, cols, DEAD_SLOT_OFFSET)
        return excl_rows, excl_cols, excl_w

    return build


def apply_exclusions(scores: torch.Tensor, excl_rows, excl_cols,
                     excl_w) -> torch.Tensor:
    """Scatter-min the exclusion triple (tensors on ``scores``' device)
    onto ``scores`` [b, n] in place: idempotent under duplicate train
    pairs, where an add would stack."""
    n = scores.shape[1]
    flat = excl_rows.long() * n + excl_cols.long()
    scores.view(-1).scatter_reduce_(0, flat, excl_w, "amin")
    return scores


def lax_order(top: torch.Tensor, idx: torch.Tensor):
    """Top-k pairs in any order re-sorted to ``lax.top_k``'s: score
    descending, lower index first among equal scores."""
    idx, by_idx = idx.sort(dim=-1)
    top = top.gather(-1, by_idx)
    top, by_score = top.sort(dim=-1, descending=True, stable=True)
    return top, idx.gather(-1, by_score)


def lax_top_k(scores: torch.Tensor, k: int):
    """``torch.topk`` along the last axis in ``lax.top_k``'s order. Which
    of several tied indices enters at the k-th place is ``torch.topk``'s
    choice."""
    return lax_order(*torch.topk(scores, k, dim=-1))


def score_rows(U_chunk, V, item_w, excl_rows, excl_cols,
               excl_w) -> torch.Tensor:
    """One query chunk's f32 ``[b, n]`` scores on the device: ``U_chunk @
    Vᵀ`` (bf16 upcast, TF32 off) ``+ item_w``, exclusions scatter-min'ed."""
    with ieee_f32():
        scores = U_chunk.float() @ V.float().T
    scores += item_w
    return apply_exclusions(scores, excl_rows, excl_cols, excl_w)


def topk_step(U_chunk, V, item_w, excl_rows, excl_cols, excl_w, *,
              k_out: int):
    """``score_rows``' top ``k_out`` in ``lax.top_k``'s order: ``(values
    f32 [b, k_out], rows int64 [b, k_out])`` on the device, no host read."""
    return lax_top_k(score_rows(U_chunk, V, item_w, excl_rows, excl_cols,
                                excl_w), k_out)


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


def ids_of_top(values, rows, ids_of_row, n_rows: int):
    """Row-space top-K in external ids, on its device: ``(scores f32,
    ids int64)``, ``ids_of_row[rows]`` and the scores, with -1 / 0.0 in a
    dead slot (``values <= DEAD_SLOT_THRESHOLD``: an excluded or masked
    row, -inf mesh padding) or a surfaced pad row (``rows >= n_rows``)."""
    real = (values > DEAD_SLOT_THRESHOLD) & (rows < n_rows)
    ids = torch.where(real, ids_of_row[rows.clamp(max=n_rows - 1)], -1)
    return torch.where(real, values, 0.0), ids


def fill_unknown(known, ids, scores):
    """Answer rows for every query: the known queries' ``(ids, scores)``
    in order, -1 / 0.0 rows for the unknown ones."""
    out_ids = np.full((len(known), ids.shape[1]), -1, np.int64)
    out_scores = np.zeros(out_ids.shape, np.float32)
    out_ids[known], out_scores[known] = ids, scores
    return out_ids, out_scores


def run_pipelined_topk(user_rows, *, k: int, k_out: int, n_rows: int,
                       slice_size: int, bucket_fn, score_chunk,
                       on_batch=None, on_drain=None, ids_of_row=None):
    """The chunk loop: walk ``user_rows`` in ``slice_size`` slices, pad
    each to ``bucket_fn(len(slice))`` rows, dispatch ``score_chunk(
    cu_padded, c) -> (v_top, r_top)`` (device work, no host read), copy
    its results back asynchronously and drain them ONE chunk behind (the
    span ``serving/drain`` waits for that chunk's copy alone), so host
    staging of chunk i+1 overlaps device scoring of chunk i.
    ``on_batch(bucket)`` observes each dispatch; ``on_drain()`` fires
    after each drain (the request plane's ``topk_merge`` mark: the card's
    time of the chunk lands in it). Returns ``(rows int32 [n, k], scores
    f32 [n, k])``, surfaced pad rows (≥ ``n_rows``) clamped to row 0 /
    -inf; with ``ids_of_row`` (the row → id map, an int64 tensor on the
    device) each chunk is mapped by ``ids_of_top`` before its copy back,
    and the result is ``(ids int64, scores f32)``, -1 / 0.0 in dead slots,
    pad rows and past ``k_out``.
    """
    # at the call: obs imports utils.metrics, which imports this module
    from large_scale_recommendation_tpu_torch.obs.trace import span

    n = len(user_rows)
    if ids_of_row is None:
        out_rows = np.zeros((n, k), np.int32)
        out_scores = np.full((n, k), -np.inf, np.float32)
    else:
        out_rows = np.full((n, k), -1, np.int64)
        out_scores = np.zeros((n, k), np.float32)
    if n == 0:
        return out_rows, out_scores
    pending = None  # (c0, c, values readback, rows readback)

    def drain(p):
        p0, pc, pv, pr = p
        with span("serving/drain"):
            out_rows[p0:p0 + pc, :k_out] = pr.numpy()[:pc]
            out_scores[p0:p0 + pc, :k_out] = pv.numpy()[:pc]
        if on_drain is not None:
            on_drain()

    for c0 in range(0, n, slice_size):
        cu = user_rows[c0:c0 + slice_size]
        c = len(cu)
        bucket = bucket_fn(c)
        if c < bucket:
            cu = np.concatenate([cu, np.zeros(bucket - c, cu.dtype)])
        v_top, r_top = score_chunk(cu, c)
        if ids_of_row is not None:
            v_top, r_top = ids_of_top(v_top, r_top, ids_of_row, n_rows)
        current = (c0, c, _Readback(v_top), _Readback(r_top))
        if on_batch is not None:
            on_batch(bucket)
        if pending is not None:
            drain(pending)
        pending = current
    drain(pending)
    if ids_of_row is None:
        pad_hits = out_rows >= n_rows  # surfaced padding rows
        out_rows[pad_hits] = 0
        out_scores[pad_hits] = -np.inf
    return out_rows, out_scores


def recommend_rows(U, V, user_rows, *, k: int, train_u=None, train_i=None,
                   chunk: int = 2048, item_mask=None, ids_of_row=None):
    """Full-catalog top-K of ``user_rows`` (rows of ``U``) over ``V`` on
    the tables' device: ``topk_step`` in ``chunk``-row slices, unpadded,
    TF32 off for the call; ``train_u``/``train_i`` rows are excluded.
    ``ids_of_row`` as ``run_pipelined_topk``'s, else row space."""
    user_rows = np.asarray(user_rows, dtype=np.int64)
    dev, n_rows = U.device, int(V.shape[0])
    k_out = min(k, n_rows)
    item_w = to_device(item_weights(n_rows, item_mask), dev)
    build_excl = exclusion_builder(train_u, train_i, int(U.shape[0]))

    def score_chunk(cu, c):
        excl = [to_device(a, dev) for a in build_excl(cu, c)]
        return topk_step(U[to_device(cu, dev)], V, item_w, *excl,
                         k_out=k_out)

    with ieee_f32():
        return run_pipelined_topk(
            user_rows, k=k, k_out=k_out, n_rows=n_rows, slice_size=chunk,
            bucket_fn=lambda c: c, score_chunk=score_chunk,
            ids_of_row=ids_of_row)
