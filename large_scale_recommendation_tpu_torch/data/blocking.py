"""Host-side DSGD blocking: id compaction, block assignment, stratum layout
(counterpart of ``large_scale_recommendation_tpu.data.blocking``; the layout
is bit-equal to the JAX package's for the same ratings and seed).

- ids are compacted to dense rows; rows are dealt into ``num_blocks``
  equal-size blocks (block b owns rows ``[b·rpb, (b+1)·rpb)``);
- ratings are bucketed into the k×k grid and laid out stratum-major:
  stratum ``s`` covers the k row-disjoint blocks ``{(p, (p+s) mod k)}``;
- per-id occurrence counts (omegas) are dense per-row arrays for the λ/ω
  regularizer;
- every block is padded to the same nnz with weight-0 entries.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data.native import (
    compact_ids,
    minibatch_inv_counts_flat,
    stable_bucket,
)


@dataclasses.dataclass(frozen=True)
class IdIndex:
    """Dense row layout for one factor matrix (user or item side): global
    row ``b * rows_per_block + j``."""

    ids: np.ndarray  # int64[num_rows_padded]; -1 marks padding rows
    num_blocks: int
    rows_per_block: int
    omega: np.ndarray  # float32[num_rows_padded] occurrence counts
    sorted_ids: np.ndarray  # int64[n_real] — for vectorized lookup
    sorted_rows: np.ndarray  # int64[n_real] rows aligned with sorted_ids

    @property
    def num_rows(self) -> int:
        return self.ids.shape[0]

    def rows_for(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Map external ids to rows; unknown ids get row 0 with mask 0."""
        ids = np.asarray(ids, dtype=np.int64)
        if self.sorted_ids.size == 0:
            return np.zeros(len(ids), np.int64), np.zeros(len(ids), np.float32)
        pos = np.searchsorted(self.sorted_ids, ids)
        pos = np.clip(pos, 0, self.sorted_ids.size - 1)
        found = self.sorted_ids[pos] == ids
        rows = np.where(found, self.sorted_rows[pos], 0)
        return rows, found.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class BlockedRatings:
    """Stratum-major blocked ratings: arrays of shape ``[k (stratum s),
    k (user block p), block_nnz]``; entry ``[s, p, :]`` is rating block
    (p, (p+s) mod k). ``block_nnz`` is padded to a multiple of the
    minibatch."""

    u_rows: np.ndarray  # int32[k, k, bmax] global user rows
    i_rows: np.ndarray  # int32[k, k, bmax] global item rows
    values: np.ndarray  # float32[k, k, bmax]
    weights: np.ndarray  # float32[k, k, bmax] 1=real 0=pad
    num_blocks: int
    nnz: int  # real rating count
    max_pad_ratio: float  # padded size / real size


@dataclasses.dataclass(frozen=True)
class BlockedProblem:
    users: IdIndex
    items: IdIndex
    ratings: BlockedRatings


def build_id_index(
    ids: np.ndarray,
    num_blocks: int,
    seed: int | None,
    row_multiple: int = 8,
    return_rows: bool = False,
) -> IdIndex | tuple[IdIndex, np.ndarray]:
    """Compact ids to dense rows and deal rows into equal-size blocks:
    a seeded shuffle, a stable sort by descending count, then a serpentine
    deal so per-block nnz sums stay near-equal on power-law data.

    With ``return_rows=True`` also returns each input occurrence's row."""
    ids = np.asarray(ids)
    uniq, inverse, counts = compact_ids(ids)
    order0 = np.argsort(uniq)
    uniq, counts = uniq[order0], counts[order0]
    n = len(uniq)
    rng = np.random.default_rng(seed if seed is not None else None)
    perm = rng.permutation(n)
    perm = perm[np.argsort(-counts[perm], kind="stable")]

    rows_per_block = max(-(-n // num_blocks), 1)  # ceil, ≥1
    rows_per_block = -(-rows_per_block // row_multiple) * row_multiple
    total = rows_per_block * num_blocks

    out_ids = np.full(total, -1, dtype=np.int64)
    omega = np.zeros(total, dtype=np.float32)
    # serpentine deal: round r visits blocks 0..B-1 when r is even,
    # B-1..0 when odd
    k_idx = np.arange(n)
    rnd, pos = k_idx // num_blocks, k_idx % num_blocks
    block = np.where(rnd % 2 == 0, pos, num_blocks - 1 - pos)
    rows = block * rows_per_block + rnd
    shuffled_ids = uniq[perm].astype(np.int64)
    out_ids[rows] = shuffled_ids
    omega[rows] = counts[perm]
    order = np.argsort(shuffled_ids)
    index = IdIndex(
        ids=out_ids,
        num_blocks=num_blocks,
        rows_per_block=rows_per_block,
        omega=omega,
        sorted_ids=shuffled_ids[order],
        sorted_rows=rows[order],
    )
    if not return_rows:
        return index
    # occurrence → row: invert the two reorderings (id-sort, then deal perm)
    row_of_sorted_pos = np.empty(n, dtype=np.int64)
    row_of_sorted_pos[perm] = rows
    inv_order0 = np.empty(n, dtype=np.int64)
    inv_order0[order0] = np.arange(n)
    return index, row_of_sorted_pos[inv_order0[inverse]]


def block_ratings(
    ratings: Ratings | tuple,
    users: IdIndex,
    items: IdIndex,
    minibatch_multiple: int = 1,
    seed: int | None = 0,
    precomputed_rows: tuple[np.ndarray, np.ndarray] | None = None,
    minibatch_sort: str | None = None,
) -> BlockedRatings:
    """Bucket ratings into the k×k grid in stratum-major layout.

    A ``Ratings`` batch may hold weight-0 padding (filtered here); a raw
    ``(ru, ri, rv)`` tuple must hold real ratings only. Within each block
    ratings are shuffled with a seeded RNG. ``minibatch_sort`` ("user" |
    "item" | None) re-orders entries within each minibatch chunk by that
    side's row — a memory-locality lever that leaves minibatch membership,
    and so the math, unchanged."""
    if minibatch_sort not in (None, "user", "item"):
        raise ValueError(
            f"minibatch_sort must be None|'user'|'item', got {minibatch_sort!r}"
        )
    if isinstance(ratings, Ratings):
        ru, ri, rv, rw = ratings.to_numpy()
        real = rw > 0
        if not real.all():
            ru, ri, rv = ru[real], ri[real], rv[real]
    else:
        ru, ri, rv = ratings[:3]
    k = users.num_blocks
    if items.num_blocks != k:
        raise ValueError("user and item block counts must match")

    if precomputed_rows is not None:
        urow, irow = precomputed_rows
    else:
        urow, umask = users.rows_for(ru)
        irow, imask = items.rows_for(ri)
        if not (umask.all() and imask.all()):
            raise ValueError("block_ratings: ratings contain ids absent from "
                             "the id indices")
    ublk = urow // users.rows_per_block
    iblk = irow // items.rows_per_block
    # stratum step s at which block (p, q) is visited: q = (p+s) mod k
    strat = (iblk - ublk) % k

    rng = np.random.default_rng(0 if seed is None else seed + 7919)
    perm = rng.permutation(len(urow))
    order = stable_bucket(strat * k + ublk, perm, k * k)
    urow, irow = urow[order], irow[order]
    vals = np.asarray(rv, dtype=np.float32)[order]
    strat_s, ublk_s = strat[order], ublk[order]

    flat = strat_s * k + ublk_s
    sizes = np.bincount(flat, minlength=k * k)
    bmax = int(sizes.max()) if len(sizes) else 0
    bmax = max(bmax, 1)
    bmax = -(-bmax // minibatch_multiple) * minibatch_multiple

    u_out = np.zeros((k, k, bmax), dtype=np.int32)
    i_out = np.zeros((k, k, bmax), dtype=np.int32)
    v_out = np.zeros((k, k, bmax), dtype=np.float32)
    w_out = np.zeros((k, k, bmax), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for s in range(k):
        for p in range(k):
            a, b = starts[s * k + p], starts[s * k + p + 1]
            m = b - a
            u_out[s, p, :m] = urow[a:b]
            i_out[s, p, :m] = irow[a:b]
            v_out[s, p, :m] = vals[a:b]
            w_out[s, p, :m] = 1.0
    if minibatch_sort is not None:
        key = u_out if minibatch_sort == "user" else i_out
        mb = minibatch_multiple
        n_mb = bmax // mb if mb > 1 else 0
        if n_mb:
            # weight-0 padding has row 0 and sorts first within its chunk
            shape = (k, k, n_mb, mb)
            order = np.argsort(key.reshape(shape), axis=-1, kind="stable")
            for arr in (u_out, i_out, v_out, w_out):
                arr[...] = np.take_along_axis(
                    arr.reshape(shape), order, axis=-1
                ).reshape(k, k, bmax)
    nnz = len(urow)
    return BlockedRatings(
        u_rows=u_out,
        i_rows=i_out,
        values=v_out,
        weights=w_out,
        num_blocks=k,
        nnz=nnz,
        max_pad_ratio=(k * k * bmax) / max(nnz, 1),
    )


def minibatch_inv_counts(
    blocked: BlockedRatings, minibatch: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-entry 1/(occurrences of this row in its minibatch), both sides —
    the precomputed scales of the "mean" collision mode. Padding entries
    get 1."""
    w = blocked.weights.reshape(-1)

    def side(rows: np.ndarray) -> np.ndarray:
        inv = minibatch_inv_counts_flat(rows.reshape(-1), w, minibatch)
        return inv.reshape(rows.shape)

    return side(blocked.u_rows), side(blocked.i_rows)


def block_problem(
    ratings: Ratings,
    num_blocks: int,
    seed: int | None = 0,
    minibatch_multiple: int = 1,
    row_multiple: int = 8,
    minibatch_sort: str | None = None,
) -> BlockedProblem:
    """Full blocking pass: both id indices + stratum-major rating blocks.
    Weight-0 entries neither register ids nor count toward omegas."""
    ru, ri, rv, rw = ratings.to_numpy()
    real = rw > 0
    if not real.all():
        ru, ri, rv = ru[real], ri[real], rv[real]
    users, urow = build_id_index(ru, num_blocks, seed, row_multiple,
                                 return_rows=True)
    items, irow = build_id_index(
        ri, num_blocks, None if seed is None else seed + 1, row_multiple,
        return_rows=True,
    )
    blocked = block_ratings((ru, ri, rv), users, items, minibatch_multiple,
                            seed=seed, precomputed_rows=(urow, irow),
                            minibatch_sort=minibatch_sort)
    return BlockedProblem(users=users, items=items, ratings=blocked)
