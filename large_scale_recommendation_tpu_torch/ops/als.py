"""ALS: normal-equation assembly + batched Cholesky solve (counterpart of
``large_scale_recommendation_tpu.ops.als``).

Each half-step solves one side's per-row normal equations with the other
side fixed, in three parts, all ordinary torch ops on the tables' device:

    plan (once)     sort ratings by the solved side's row; group rows into
                    BUCKETS by power-of-2-padded rating count, on the host
                    (``build_solve_plan`` + ``prepare_side``) or on the
                    device (``device_prepare_side``); the buckets are cut
                    into row chunks of at most ``target_bytes``,
    gram            per chunk: gather the fixed side's rows ``[rc, pad, k]``
                    and batch-contract them (``bmm``) into ``[rc, k, k]``
                    grams and ``[rc, k]`` right-hand sides,
    solve           (A + λ·s·I) x = b for the chunk's rows: batched
                    ``cholesky_ex`` and two triangular solves, then an
                    ``index_copy_`` into a ``[num_rows + 1, k]`` table whose
                    last row takes the chunk-padding rows.

The JAX package compiles one scan per bucket; here the chunk loop is a host
loop of eager ops. Products run in IEEE f32 (TF32 off for the duration of a
half-step, whatever the process set). ``cholesky_ex`` does not synchronize;
a system that is not positive definite solves to NaN, as ``jnp.linalg
.cholesky`` does, instead of raising.

Regularization: ``"direct"`` s = 1; ``"als_wr"`` s = ω (the row's rating
count), floored at 1 so empty rows stay positive definite. Implicit
feedback (iALS): gram weights c − 1 = α·r, targets c = 1 + α·r, plus the
fixed side's whole VᵀV gram ``G`` added to every row's system. Rows with
no ratings solve to exactly 0.

``gram_dtype`` bf16 (``solve_side(dtype=torch.bfloat16)``) gathers bf16
rows, as the JAX package does; the row weights and targets are rounded to
bf16 as there, and the products (exact in f32: bf16 × bf16), the
contractions and the solve run in f32, as the JAX einsums'
``preferred_element_type=f32`` compile on the CPU. The solved side is f32.

The fused route (``fused_route``: a card, f32, k ≤ 128; ``ALS.fit_device``
takes it there) has a plan of its own, a ``CsrPlan`` (``device_csr_plan``:
the rows with ratings longest first, each row's entries contiguous with
partners ascending), and solves a half-step in ONE launch of
``csrc/als_solve.cu``: per row, the partner rows gathered into shared
memory, the gram's lower triangle and b in registers, the ridge, a
Cholesky factorisation and both solves on the SM, so no padded gather,
gram or library solve reaches device memory. ``als_solve`` launches it for
CUDA tensors (counted in ``LAUNCHES``) and runs ``als_solve_reference``,
its plain version (rows in chunks of similar length, the bucketed route's
gram and ``solve_normal_eq``), for CPU tensors. Everything else (the CPU,
bf16 grams, k > 128, host plans, the mesh) stays on the bucketed route.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.obs.trace import span
from large_scale_recommendation_tpu_torch.ops import _build
from large_scale_recommendation_tpu_torch.ops.topk import ieee_f32
from large_scale_recommendation_tpu_torch.utils.device import resolve_device

# classes of the device plan: rows with up to 2^30 ratings
_N_POW2 = 31
# the fused route's largest rank (csrc/als_solve.cu: 128×128 systems)
FUSED_MAX_K = 128
# launches since the last reset: one a fused half-step
LAUNCHES = {"als_solve_launch": 0}
_LIB = "als_solve"
_bound: ctypes.CDLL | None = None


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Host-built layout for solving ONE side's normal equations.

    ``buckets``: tuples ``(rows, other_idx, vals, w)`` of numpy arrays with
    shapes ``int32[nb]``, ``int32[nb, pad]``, ``float32[nb, pad]``,
    ``float32[nb, pad]``; every output row with ≥1 rating appears in
    exactly one bucket; pad slots carry weight 0 and index 0.
    ``num_rows``: the solved side's table height.
    """

    buckets: tuple
    num_rows: int

    @property
    def padded_nnz(self) -> int:
        return sum(b[1].size for b in self.buckets)


def build_solve_plan(
    out_rows: np.ndarray,
    other_rows: np.ndarray,
    values: np.ndarray,
    num_out_rows: int,
    min_pad: int = 8,
) -> SolvePlan:
    """Sort by output row (partners ascending inside a row) and bucket rows
    by power-of-2 rating count (at least ``min_pad``). One host pass per
    orientation; numpy, the JAX package's code."""
    out_rows = np.asarray(out_rows, dtype=np.int64)
    other_rows = np.asarray(other_rows)
    values = np.asarray(values)
    order = np.lexsort((other_rows, out_rows))
    o_sorted = other_rows[order].astype(np.int32)
    v_sorted = values[order].astype(np.float32)
    counts = np.bincount(out_rows, minlength=num_out_rows)
    starts = np.concatenate([[0], np.cumsum(counts)])
    nnz = len(out_rows)

    active = np.nonzero(counts)[0]
    if len(active) == 0:
        return SolvePlan(buckets=(), num_rows=num_out_rows)
    pads = np.maximum(min_pad,
                      2 ** np.ceil(np.log2(counts[active])).astype(np.int64))
    buckets = []
    for pad in np.unique(pads):
        rows = active[pads == pad]
        pos = starts[rows][:, None] + np.arange(pad)[None, :]
        valid = np.arange(pad)[None, :] < counts[rows][:, None]
        pos = np.clip(pos, 0, max(nnz - 1, 0))
        oidx = np.where(valid, o_sorted[pos], 0).astype(np.int32)
        vals = np.where(valid, v_sorted[pos], 0.0).astype(np.float32)
        w = valid.astype(np.float32)
        buckets.append((rows.astype(np.int32), oidx, vals, w))
    return SolvePlan(buckets=tuple(buckets), num_rows=num_out_rows)


def _chunk_geometry(nb: int, pad: int, k: int,
                    target_bytes: int) -> tuple[int, int, int]:
    """Row-chunk size for one bucket: pow2 ``rc`` such that both the
    [rc, pad, k] gather and the [rc, k, k] gram stay ≤ target_bytes.
    Returns (rc, n_chunks, padded_nb)."""
    rc = max(1, min(target_bytes // (pad * k * 4),
                    target_bytes // (k * k * 4)))
    rc = 1 << (rc.bit_length() - 1)  # floor pow2
    rc = min(rc, 1 << (max(nb - 1, 1)).bit_length())  # don't exceed ~nb
    n_chunks = -(-nb // rc)
    return rc, n_chunks, n_chunks * rc


def _chunked_bucket(bucket, omega, num_rows, k, target_bytes=256 << 20,
                    device=None):
    """One bucket as ``[n_chunks, rc, pad]`` tensors on ``device`` (the
    bucket's own device for tensors); chunk-padding rows point at the dummy
    row ``num_rows`` with weight 0. The one copy of the chunk layout, shared
    by the host and the device plan. ``omega``: a float32 tensor on that
    device, or None."""
    rows, oidx, vals, w = bucket
    nb, pad = oidx.shape
    rc, n_chunks, padded_nb = _chunk_geometry(nb, pad, k, target_bytes)
    if device is None:
        device = rows.device

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rows, oidx = put(rows, torch.int32), put(oidx, torch.int32)
    vals, w = put(vals, torch.float32), put(w, torch.float32)
    if padded_nb != nb:
        extra = padded_nb - nb
        rows = torch.cat([rows, torch.full((extra,), num_rows,
                                           dtype=torch.int32, device=device)])
        zeros = torch.zeros((extra, pad), dtype=torch.float32, device=device)
        oidx = torch.cat([oidx, zeros.to(torch.int32)])
        vals = torch.cat([vals, zeros])
        w = torch.cat([w, zeros])
    scale = (omega[rows.clamp_max(num_rows - 1).long()]
             if omega is not None
             else torch.ones(padded_nb, dtype=torch.float32, device=device))
    return (
        rows.reshape(n_chunks, rc),
        oidx.reshape(n_chunks, rc, pad),
        vals.reshape(n_chunks, rc, pad),
        w.reshape(n_chunks, rc, pad),
        scale.reshape(n_chunks, rc),
    )


def prepare_side(plan: SolvePlan, omega, k: int,
                 implicit_alpha: float | None = None, device=None):
    """Chunked buckets of one orientation on ``device`` (``None``: the
    card), built once per fit and reused every round.

    ``implicit_alpha`` switches the entries to iALS semantics: gram weights
    become c−1 = α·r and b-targets c = 1+α·r (masked); the caller adds the
    shared VᵀV gram via ``solve_side(..., G=...)``."""
    dev = resolve_device(device)
    buckets = plan.buckets
    if implicit_alpha is not None:
        a = np.float32(implicit_alpha)
        buckets = tuple(
            (rows, oidx, (w * (1.0 + a * vals)).astype(np.float32),
             (w * a * vals).astype(np.float32))
            for (rows, oidx, vals, w) in buckets
        )
    om = (None if omega is None
          else torch.as_tensor(np.asarray(omega, np.float32), device=dev))
    return tuple(_chunked_bucket(b, om, plan.num_rows, k, device=dev)
                 for b in buckets)


def _row_major_entries(out_rows, other_rows, num_out_rows: int):
    """Per-row counts, the entries' order by (out_row, other_row) and each
    row's first entry in that order: the sort both device plans share."""
    counts = torch.bincount(out_rows.long(), minlength=num_out_rows)
    # lexsort by (out_row, other_row) as two stable passes: row-contiguous
    # runs with ascending partners, as the host plan's np.lexsort
    o1 = torch.sort(other_rows, stable=True).indices
    entry_order = o1[torch.sort(out_rows[o1], stable=True).indices]
    starts = torch.cumsum(counts, 0) - counts
    return counts, entry_order, starts


def _device_plan_keys(out_rows, other_rows, num_out_rows: int,
                      n_pow2: int):
    """Per-row counts, pad classes, and the two sort orders of the device
    plan, plus the per-class row counts that are read back."""
    dev = out_rows.device
    counts, entry_order, starts = _row_major_entries(out_rows, other_rows,
                                                     num_out_rows)
    pow2s = torch.pow(2, torch.arange(n_pow2, dtype=torch.int64, device=dev))
    # smallest pow2 ≥ count in exact integer logic; empty rows get a
    # trailing pseudo-class that is sliced off
    pclass = torch.searchsorted(pow2s, counts, right=False)
    pclass = torch.where(counts == 0, n_pow2, pclass)
    row_order = torch.sort(pclass, stable=True).indices  # rows by class
    rows_per_class = torch.bincount(pclass, minlength=n_pow2 + 1)
    return counts, row_order, rows_per_class, entry_order, starts


def _device_bucket(row_order, counts, starts, o_sorted, v_sorted,
                   pad: int, offset: int, nb: int):
    """One pad-class bucket [nb, pad] on the device (the where/clip gather
    of ``build_solve_plan``)."""
    rows = row_order[offset:offset + nb]
    ar = torch.arange(pad, dtype=torch.int64, device=rows.device)
    pos = starts[rows][:, None] + ar[None, :]
    valid = ar[None, :] < counts[rows][:, None]
    e = o_sorted.shape[0]
    pos = pos.clamp(0, max(e - 1, 0))
    oidx = torch.where(valid, o_sorted[pos], 0).to(torch.int32)
    vals = torch.where(valid, v_sorted[pos], 0.0).to(torch.float32)
    w = valid.to(torch.float32)
    return rows.to(torch.int32), oidx, vals, w


def device_prepare_side(
    out_rows,
    other_rows,
    values,
    num_out_rows: int,
    omega=None,
    min_pad: int = 8,
    target_bytes: int = 256 << 20,
    rank_for_chunking: int | None = None,
    device=None,
):
    """Build one orientation's chunked solve buckets on the device: the
    counterpart of ``build_solve_plan`` + ``prepare_side`` as torch ops.
    The only device→host traffic is the 32-entry per-class row count.
    Inputs are tensors (on their device) or host arrays (moved to
    ``device``, ``None``: the card); dense rows in ``[0, num_out_rows)``.

    ``rank_for_chunking`` sets the chunk-geometry rank (default 256, so one
    layout serves any rank up to it within ``target_bytes``)."""
    if min_pad <= 0 or min_pad & (min_pad - 1) != 0:
        raise ValueError(f"min_pad must be a power of 2, got {min_pad}")
    dev = (out_rows.device if isinstance(out_rows, torch.Tensor)
           else resolve_device(device))

    def put(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    out_rows = put(out_rows, torch.int32)
    other_rows = put(other_rows, torch.int32)
    values = put(values, torch.float32)
    k = rank_for_chunking or 256
    counts, row_order, rows_per_class, entry_order, starts = \
        _device_plan_keys(out_rows, other_rows, num_out_rows, _N_POW2)
    o_sorted = other_rows[entry_order]
    v_sorted = values[entry_order]

    rpc = rows_per_class.cpu().numpy()  # the one readback
    offsets = np.concatenate([[0], np.cumsum(rpc)])
    # classes whose pow2 ≤ min_pad share one min_pad bucket (adjacent in
    # row_order: one contiguous slice, rows ordered by class)
    m = min_pad.bit_length() - 1
    groups = [(min_pad, 0, int(rpc[: m + 1].sum()))]
    groups += [(1 << cls, int(offsets[cls]), int(rpc[cls]))
               for cls in range(m + 1, _N_POW2)]
    om = None if omega is None else put(omega, torch.float32)
    prepared = []
    for pad, offset, nb in groups:  # the trailing class (empty rows) is out
        if nb == 0:
            continue
        bucket = _device_bucket(row_order, counts, starts, o_sorted,
                                v_sorted, pad, offset, nb)
        prepared.append(_chunked_bucket(bucket, om, num_out_rows, k,
                                        target_bytes))
    return tuple(prepared)


def implicit_prepared(prepared, alpha: float):
    """iALS re-weighting of EXPLICIT chunked buckets on their device: gram
    weight c − 1 = α·v, b-weight c = w + α·v (``vals`` is pre-masked), the
    values of ``prepare_side(..., implicit_alpha=α)`` up to one rounding."""
    a = float(np.float32(alpha))
    return tuple((rows3, oidx3, w3 + a * vals3, a * vals3, sc3)
                 for rows3, oidx3, vals3, w3, sc3 in prepared)


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """One orientation's plan for the fused half-step, on one device.

    ``rows`` int32 [n]: the solved rows with ratings, longest first (ties
    by row); ``ptr`` int64 [n] and ``cnt`` int32 [n]: each one's entries,
    ``cols[ptr:ptr + cnt]`` (partner rows, ascending) beside ``vals``
    (b-weights: the ratings, or the implicit confidences) and ``w`` (gram
    weights; None: 1); ``scale`` f32 [n] (ALS-WR's ω) or None;
    ``num_rows``: the solved side's table height."""

    rows: torch.Tensor
    ptr: torch.Tensor
    cnt: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    w: torch.Tensor | None
    scale: torch.Tensor | None
    num_rows: int


def fused_route(device, k: int, gram_dtype=None) -> bool:
    """Whether a half-step takes the fused kernel: the fixed side on a
    card, in f32, at rank ≤ ``FUSED_MAX_K``."""
    return (torch.device(device).type == "cuda" and gram_dtype is None
            and k <= FUSED_MAX_K)


def device_csr_plan(out_rows, other_rows, values, num_out_rows: int,
                    omega=None, device=None) -> CsrPlan:
    """One orientation's ``CsrPlan`` on the device (``device_prepare_side``'s
    sort, without its buckets). Inputs as ``device_prepare_side``'s; the
    count of rows with ratings is the one readback."""
    dev = (out_rows.device if isinstance(out_rows, torch.Tensor)
           else resolve_device(device))

    def put(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    out_rows = put(out_rows, torch.int32)
    other_rows = put(other_rows, torch.int32)
    values = put(values, torch.float32)
    counts, entry_order, starts = _row_major_entries(out_rows, other_rows,
                                                     num_out_rows)
    by_length = torch.sort(counts, descending=True, stable=True).indices
    rows = by_length[:int((counts > 0).sum())]
    return CsrPlan(
        rows=rows.to(torch.int32), ptr=starts[rows].contiguous(),
        cnt=counts[rows].to(torch.int32),
        cols=other_rows[entry_order].contiguous(),
        vals=values[entry_order].contiguous(), w=None,
        scale=None if omega is None else put(omega, torch.float32)[rows],
        num_rows=num_out_rows)


def implicit_csr(plan: CsrPlan, alpha: float) -> CsrPlan:
    """iALS weights on an explicit ``CsrPlan``: b-weights 1 + α·r, gram
    weights α·r (``implicit_prepared``'s values entry for entry)."""
    a = float(np.float32(alpha))
    return dataclasses.replace(plan, vals=1.0 + a * plan.vals,
                               w=a * plan.vals)


def _gram_chunk(factors, oi, va, wi, G=None):
    """One chunk's per-row grams ``A [rc, k, k]`` and right-hand sides
    ``b [rc, k]``: gather the fixed side's rows and contract them in f32
    (spans ``als/gather`` and ``als/gram``). ``G`` adds a shared [k, k]
    term to every gram (implicit VᵀV)."""
    rc, pad = oi.shape
    k = factors.shape[-1]
    on_card = factors.is_cuda
    with span("als/gather", device=on_card):
        g = torch.index_select(factors, 0, oi.reshape(-1)).view(rc, pad, k)
        if g.dtype != torch.float32:
            # the JAX bf16 route: weights and targets rounded to the
            # table's dtype, products (exact in f32) and sums in f32
            wi = wi.to(g.dtype).float()
            va = va.to(g.dtype).float()
            g = g.float()
        gw = g * wi[..., None]
    with span("als/gram", device=on_card):
        A = torch.bmm(gw.transpose(1, 2), g)
        if G is not None:
            A = A + G
        # b uses the RAW gathered rows: ``va`` is the per-entry b-weight
        # (explicit: the masked rating; implicit: the masked confidence)
        b = torch.bmm(g.transpose(1, 2), va[..., None])[..., 0]
    return A, b


def _gram_solve_chunk(factors, oi, va, wi, sc, lambda_, G=None):
    """Gram + Cholesky solve of one chunk's rows."""
    A, b = _gram_chunk(factors, oi, va, wi, G)
    return solve_normal_eq(A, b, lambda_, sc)


def _solve_bucket(factors, out, rows3, oidx3, vals3, w3, scale3, lambda_,
                  G=None):
    """Gram + solve + write-back for one bucket, chunk by chunk, into
    ``out`` (``[num_rows + 1, k]``, in place). Peak memory is one chunk's
    gather and grams. Spans ``als/gather``, ``als/gram`` (in
    ``_gram_chunk``) and ``als/solve`` (arg ``rows``) a chunk."""
    for c in range(rows3.shape[0]):
        A, b = _gram_chunk(factors, oidx3[c], vals3[c], w3[c], G)
        rows = rows3[c]
        with span("als/solve", device=factors.is_cuda, rows=rows.shape[0]):
            x = solve_normal_eq(A, b, lambda_, scale3[c])
            out.index_copy_(0, rows.long(), x)
    return out


def solve_side(
    factors_other: torch.Tensor,
    prepared,
    num_rows: int,
    lambda_: float,
    G: torch.Tensor | None = None,
    dtype=None,
) -> torch.Tensor:
    """One ALS half-step over the prepared buckets or a ``CsrPlan`` (the
    fused route, f32 only: span ``als/solve`` with counters ``rows``,
    ``fused``, the rows the kernel solved, ``entries``, the plan's
    entries, and ``weighted``, the rows with gram weights, the kernel's
    weighted build on a card); with ``G`` (the fixed side's VᵀV) the iALS
    half-step. ``dtype`` (``torch.bfloat16``) casts the fixed side once
    before the gathers; the solved side is f32."""
    if isinstance(prepared, CsrPlan):
        if dtype is not None:
            raise ValueError("the fused half-step solves in f32 only")
        if prepared.num_rows != num_rows:
            raise ValueError(f"plan of {prepared.num_rows} rows, expected "
                             f"{num_rows}")
        n = prepared.rows.shape[0]
        on_card = factors_other.is_cuda
        with span("als/solve", device=on_card, rows=n,
                  fused=n if on_card else 0,
                  entries=prepared.cols.shape[0],
                  weighted=0 if prepared.w is None else n):
            return als_solve(factors_other, prepared, lambda_, G)
    k = factors_other.shape[-1]
    if dtype is not None:
        factors_other = factors_other.to(dtype)
    out = torch.zeros((num_rows + 1, k), dtype=torch.float32,
                      device=factors_other.device)
    with ieee_f32():
        for chunked in prepared:
            _solve_bucket(factors_other, out, *chunked, lambda_, G)
    return out[:num_rows]


def build_sharded_plans(
    out_rows_local: np.ndarray,  # int64[e] LOCAL row of the solved side
    shard_of_entry: np.ndarray,  # int64[e] owning shard of each rating
    other_rows: np.ndarray,  # int64[e] GLOBAL rows into the gathered table
    values: np.ndarray,
    num_shards: int,
    rows_per_shard: int,
    k: int,
    min_pad: int = 8,
    target_bytes: int = 64 << 20,
    implicit_alpha: float | None = None,
):
    """Shard-major bucketed solve plans for a SHARDED table (numpy, the JAX
    package's code): ``build_solve_plan`` per shard, the pad classes
    unified across shards and every shard's bucket padded to the largest
    shard's row count with dummies on the local dummy row
    ``rows_per_shard``, so every shard has the same shapes. Returns per pad
    class ``(rows3 [S, C, rc], oidx3 [S, C, rc, pad], vals3, w3)``; shard
    p's part is ``Partitioner.place(a, "ratings")``."""
    plans = []
    for s in range(num_shards):
        m = shard_of_entry == s
        p = build_solve_plan(out_rows_local[m], other_rows[m],
                             values[m], rows_per_shard, min_pad=min_pad)
        if implicit_alpha is not None:
            a = np.float32(implicit_alpha)
            p = SolvePlan(
                buckets=tuple(
                    (rows, oidx, (w * (1.0 + a * vals)).astype(np.float32),
                     (w * a * vals).astype(np.float32))
                    for (rows, oidx, vals, w) in p.buckets),
                num_rows=p.num_rows)
        plans.append(p)
    pad_classes = sorted({b[1].shape[1] for p in plans for b in p.buckets})
    out = []
    for pad in pad_classes:
        per_shard = []
        for p in plans:
            hit = [b for b in p.buckets if b[1].shape[1] == pad]
            per_shard.append(hit[0] if hit else None)
        nb_max = max((b[0].shape[0] if b is not None else 0)
                     for b in per_shard)
        if nb_max == 0:
            continue
        rc, n_chunks, padded_nb = _chunk_geometry(nb_max, pad, k,
                                                  target_bytes)
        S = num_shards
        rows3 = np.full((S, padded_nb), rows_per_shard, np.int32)
        oidx3 = np.zeros((S, padded_nb, pad), np.int32)
        vals3 = np.zeros((S, padded_nb, pad), np.float32)
        w3 = np.zeros((S, padded_nb, pad), np.float32)
        for s, b in enumerate(per_shard):
            if b is None:
                continue
            rows, oidx, vals, w = b
            nb = rows.shape[0]
            rows3[s, :nb] = rows
            oidx3[s, :nb] = oidx
            vals3[s, :nb] = vals
            w3[s, :nb] = w
        out.append((rows3.reshape(S, n_chunks, rc),
                    oidx3.reshape(S, n_chunks, rc, pad),
                    vals3.reshape(S, n_chunks, rc, pad),
                    w3.reshape(S, n_chunks, rc, pad)))
    return out


def solve_side_local(
    factors_full: torch.Tensor,  # [n_other_total, k]: the gathered side
    chunked_buckets,  # per pad class (rows3 [C, rc], oidx3, vals3, w3)
    rows_per_shard: int,
    lambda_: float,
    omega_local: torch.Tensor | None,
    G: torch.Tensor | None = None,  # [k, k] shared gram (implicit VᵀV)
    dtype=None,
) -> torch.Tensor:
    """One shard's half-step on the mesh: bucketed gram + solve + write-back
    into its local ``[rows_per_shard (+1 dummy), k]`` table (``als_wr``
    scales from ``omega_local``, the dummy row's scale 1). ``dtype`` casts
    the gathered fixed side once, as ``solve_side``'s. The JAX package's
    ``varying_zeros_fn`` (shard_map's replication typing) has no
    counterpart."""
    k = factors_full.shape[-1]
    if dtype is not None:
        factors_full = factors_full.to(dtype)
    dev = factors_full.device
    out = torch.zeros((rows_per_shard + 1, k), dtype=torch.float32,
                      device=dev)
    omega_ext = (None if omega_local is None else torch.cat(
        [omega_local.float(), torch.ones(1, dtype=torch.float32,
                                         device=dev)]))
    with ieee_f32():
        for rows3, oidx3, vals3, w3 in chunked_buckets:
            for c in range(rows3.shape[0]):
                rows = rows3[c].long()
                sc = None if omega_ext is None else omega_ext[rows]
                x = _gram_solve_chunk(factors_full, oidx3[c], vals3[c],
                                      w3[c], sc, lambda_, G)
                out.index_copy_(0, rows, x)
    return out[:rows_per_shard]


def _full_gram(F: torch.Tensor) -> torch.Tensor:
    """FᵀF in IEEE f32."""
    with ieee_f32():
        return F.T @ F


def als_rounds(V, prep_u, prep_v, num_u: int, num_v: int, lambda_: float,
               iterations: int, implicit: bool = False, gram_dtype=None,
               round_ms: list | None = None):
    """``iterations`` × (user half-step; item half-step) over PREPARED
    buckets; with ``implicit`` each half-step adds the fixed side's whole
    VᵀV gram (span ``als/full_gram``, counter ``rows``: the fixed table's
    height). ``gram_dtype`` routes the gathers through a reduced-precision
    copy of the fixed side (see ``solve_side``). Given a list ``round_ms``
    and ``V`` on a card, each round's device ms (CUDA events around it) is
    appended to it after the last round."""
    timed = round_ms is not None and V.device.type == "cuda"
    events = []
    U = None

    def full_gram(F):
        if not implicit:
            return None
        with span("als/full_gram", device=F.is_cuda, rows=F.shape[0]):
            return _full_gram(F)

    for _ in range(iterations):
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        U = solve_side(V, prep_u, num_u, lambda_, full_gram(V),
                       dtype=gram_dtype)
        V = solve_side(U, prep_v, num_v, lambda_, full_gram(U),
                       dtype=gram_dtype)
        if timed:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((start, end))
    if events:
        events[-1][1].synchronize()
        round_ms.extend(a.elapsed_time(b) for a, b in events)
    return U, V


def als_train_planned(
    U: torch.Tensor,
    V: torch.Tensor,
    user_plan: SolvePlan,
    item_plan: SolvePlan,
    omega_u: np.ndarray,
    omega_v: np.ndarray,
    *,
    lambda_: float,
    iterations: int,
    reg_mode: str = "direct",
    implicit_alpha: float | None = None,
    gram_dtype=None,
    round_ms: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full ALS on host plans, on ``V``'s device: ``iterations`` × (user
    half-step; item half-step). ``implicit_alpha`` switches to iALS;
    ``round_ms`` as in ``als_rounds``."""
    k = U.shape[-1]
    omu = omega_u if reg_mode == "als_wr" else None
    omv = omega_v if reg_mode == "als_wr" else None
    prep_u = prepare_side(user_plan, omu, k, implicit_alpha, device=V.device)
    prep_v = prepare_side(item_plan, omv, k, implicit_alpha, device=V.device)
    return als_rounds(V, prep_u, prep_v, user_plan.num_rows,
                      item_plan.num_rows, lambda_, iterations,
                      implicit=implicit_alpha is not None,
                      gram_dtype=gram_dtype, round_ms=round_ms)


def gram_stats(
    factors: torch.Tensor,  # float32[n_other, k] — the FIXED side's table
    out_rows: torch.Tensor,  # int[e] rows of the side being SOLVED
    other_rows: torch.Tensor,  # int[e] rows into ``factors``
    values: torch.Tensor,  # float32[e]
    weights: torch.Tensor,  # float32[e] 1=real 0=pad
    num_out_rows: int,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row grams ``A [num_out_rows, k, k]`` and right-hand sides
    ``b [num_out_rows, k]`` by chunked scatter-add of outer products: the
    straightforward formulation, kept as the oracle the tests hold the
    bucketed solve against."""
    k = factors.shape[-1]
    e = out_rows.shape[0]
    if e % chunk:
        raise ValueError(f"nnz {e} not divisible by chunk {chunk}")
    A = torch.zeros((num_out_rows, k, k), dtype=torch.float32,
                    device=factors.device)
    b = torch.zeros((num_out_rows, k), dtype=torch.float32,
                    device=factors.device)
    for a in range(0, e, chunk):
        rows = out_rows[a:a + chunk].long()
        v = factors[other_rows[a:a + chunk].long()]
        vw = v * weights[a:a + chunk, None]
        A.index_add_(0, rows, v[:, :, None] * vw[:, None, :])
        b.index_add_(0, rows, values[a:a + chunk, None] * vw)
    return A, b


def solve_normal_eq(
    A: torch.Tensor,  # float32[n, k, k]
    b: torch.Tensor,  # float32[n, k]
    lambda_: float,
    reg_scale: torch.Tensor | None = None,  # float32[n]; None → 1
) -> torch.Tensor:
    """Solve (A + λ·s·I) x = b for every row: batched Cholesky without a
    synchronizing error check, then two triangular solves. A row whose
    system is not positive definite solves to NaN."""
    n, k = A.shape[0], A.shape[-1]
    s = (torch.ones(n, dtype=torch.float32, device=A.device)
         if reg_scale is None else reg_scale)
    # empty rows (s could be 0 under als_wr): keep the system PD with λ·I
    s = s.clamp_min(1.0)
    lam = float(np.float32(lambda_))
    ridge = (lam * s)[:, None, None] * torch.eye(k, dtype=torch.float32,
                                                 device=A.device)
    L, info = torch.linalg.cholesky_ex(A + ridge)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info == 0)[:, None], x, float("nan"))


# -- the fused half-step (csrc/als_solve.cu) ---------------------------------


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The built library with its ctypes signature declared."""
    global _bound
    if _bound is not None:
        return _bound
    with _build.lock(_LIB):
        if _bound is None:
            lib = _build.load_library(_LIB)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.als_solve_launch.restype = I
            lib.als_solve_launch.argtypes = ([P, I] + [P] * 8
                                             + [ctypes.c_float, P, I, P])
            _bound = lib
    return _bound


def _check_fused(F, plan: CsrPlan, G):
    """Refuse what the kernel does not take (on any device)."""
    if F.dim() != 2 or F.dtype != torch.float32:
        raise ValueError(f"the fused half-step takes an f32 [n, k] fixed "
                         f"side, got {F.dtype} {tuple(F.shape)}")
    k = F.shape[1]
    if not 1 <= k <= FUSED_MAX_K:
        raise ValueError(f"rank {k} outside [1, {FUSED_MAX_K}]: the fused "
                         "half-step solves at most 128×128 systems")
    n, e = plan.rows.shape[0], plan.cols.shape[0]
    want = [("F", F, torch.float32, None),
            ("rows", plan.rows, torch.int32, n),
            ("ptr", plan.ptr, torch.int64, n),
            ("cnt", plan.cnt, torch.int32, n),
            ("cols", plan.cols, torch.int32, e),
            ("vals", plan.vals, torch.float32, e)]
    if plan.w is not None:
        want.append(("w", plan.w, torch.float32, e))
    if plan.scale is not None:
        want.append(("scale", plan.scale, torch.float32, n))
    if G is not None:
        want.append(("G", G, torch.float32, None))
        if tuple(G.shape) != (k, k):
            raise ValueError(f"G has shape {tuple(G.shape)}, expected "
                             f"({k}, {k})")
    for name, t, dtype, length in want:
        if t.device != F.device:
            raise ValueError(f"{name} on {t.device}, expected {F.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
        if length is not None and (t.dim() != 1 or t.shape[0] != length):
            raise ValueError(f"{name} must be 1-D of length {length}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def als_solve(F: torch.Tensor, plan: CsrPlan, lambda_: float,
              G: torch.Tensor | None = None) -> torch.Tensor:
    """One fused half-step: ``[plan.num_rows, k]`` f32, rows without
    ratings 0, rows whose system is not positive definite NaN. The kernel
    for CUDA tensors, ``als_solve_reference`` for CPU tensors; there is no
    fallback."""
    _check_fused(F, plan, G)
    if not F.is_cuda:
        return als_solve_reference(F, plan, lambda_, G)
    k = F.shape[1]
    out = torch.zeros((plan.num_rows, k), dtype=torch.float32,
                      device=F.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rc = _lib().als_solve_launch(
        F.data_ptr(), k, plan.rows.data_ptr(), plan.ptr.data_ptr(),
        plan.cnt.data_ptr(), plan.cols.data_ptr(), plan.vals.data_ptr(),
        ptr(plan.w), ptr(plan.scale), ptr(G),
        float(np.float32(lambda_)), out.data_ptr(),
        int(plan.rows.shape[0]),
        torch.cuda.current_stream(F.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"als_solve_launch failed: CUDA error {rc}")
    LAUNCHES["als_solve_launch"] += 1
    return out


def als_solve_reference(F: torch.Tensor, plan: CsrPlan, lambda_: float,
                        G: torch.Tensor | None = None,
                        target_bytes: int = 256 << 20) -> torch.Tensor:
    """The kernel's plain version: the plan's rows in chunks (rows of
    similar length, longest first, each padded to its chunk's longest with
    weight-0 entries), each chunk's grams, ridge, Cholesky and two solves
    as the bucketed route computes them (``_gram_chunk``,
    ``solve_normal_eq``), written to the rows of a zeroed table."""
    k = F.shape[1]
    dev = F.device
    out = torch.zeros((plan.num_rows, k), dtype=torch.float32, device=dev)
    cnt = plan.cnt.cpu().numpy()
    n = cnt.shape[0]
    a = 0
    with ieee_f32():
        while a < n:
            longest = int(cnt[a])
            rc = max(1, target_bytes // (4 * k * (longest + k)))
            b = min(n, a + rc)
            ar = torch.arange(longest, dtype=torch.int64, device=dev)
            pos = plan.ptr[a:b, None] + ar[None, :]
            valid = ar[None, :] < plan.cnt[a:b, None]
            pos = torch.where(valid, pos, 0)
            oi = torch.where(valid, plan.cols[pos], 0)
            va = torch.where(valid, plan.vals[pos], 0.0)
            wi = (valid.to(torch.float32) if plan.w is None
                  else torch.where(valid, plan.w[pos], 0.0))
            A, rhs = _gram_chunk(F, oi, va, wi, G)
            sc = None if plan.scale is None else plan.scale[a:b]
            out.index_copy_(0, plan.rows[a:b].long(),
                            solve_normal_eq(A, rhs, lambda_, sc))
            a = b
    return out
