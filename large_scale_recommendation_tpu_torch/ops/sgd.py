"""The plain PyTorch SGD route (counterpart of
``large_scale_recommendation_tpu.ops.sgd``).

Ratings stream through in minibatches:

    gather u = U[rows], v = V[rows]          (all reads before any write)
    e = r − Σ u∘v
    ΔU, ΔV from the pluggable updater        (core.updaters)
    scatter-add ΔU into U, ΔV into V         (duplicate rows in a minibatch
                                              accumulate; minibatch g+1
                                              sees g's writes)

The minibatch loop is a host loop over eager PyTorch ops. This is the route
``models.dsgd.DSGD.fit`` takes on the CPU, and the oracle the CUDA kernels
(``ops.cuda_sgd``) are held against. It runs on any device the tensors lie
on. Unlike the JAX package's pure functions, the sweeps update the tables
in place: ``dsgd_train`` and ``online_train`` copy their input tables once
and return the trained copies. ``online_train`` is the online micro-batch
route (``models.online``) on every device: the JAX package runs it in XLA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.parallel.collectives import (
    group_sum,
)
from large_scale_recommendation_tpu_torch.utils.shapes import next_pow2


def dsgd_bytes_per_sweep(nnz: int, rank: int, *, kernel: str = "plain",
                         factor_bytes: int = 4, user_rows: int | None = None,
                         item_rows: int | None = None,
                         model_size: int = 1) -> int:
    """Bytes of device-memory traffic one full DSGD sweep moves, per route
    (a model of each route's design, not the function's bound: that counts
    distinct rows once per step and depends on the data).

    - ``kernel="plain"`` (the gather route): every rating pays ~4 row
      transactions (read+write of a u row and a v row) of
      ``rank × factor_bytes`` plus ~16 B of COO stream.
    - ``kernel="cuda"`` (the row-owning step pair of ``csrc/dsgd_sweep.cu``
      on f32 work tables): per rating, one gathered user row (item side) and
      one snapshot row (user side), 20 B of plan on each side and 4 B of
      error written and read; per item row of a step, the row read and
      written and its snapshot written, plus ω; per user row of a step, the
      row read and written, plus ω. ``user_rows``/``item_rows`` count
      (step, row) pairs over the sweep; the default, ``nnz``, is the most
      (every rating its own row).

    ``model_size`` is the model axis of a rank-sharded mesh: each rank
    holds ``rank / model_size`` columns, so the plain route's row term
    divides by it (the COO stream does not). The step pair holds full rows
    and has no rank-sharded route, so ``model_size > 1`` there raises. The
    wire bytes of the reduction are ``dsgd_collective_bytes_per_sweep``.
    """
    if model_size < 1 or rank % model_size:
        raise ValueError(
            f"model_size {model_size} must be ≥1 and divide rank {rank}")
    if kernel == "cuda":
        if model_size != 1:
            raise ValueError("the step pair has no rank-sharded traffic "
                             "model (model_size must be 1)")
        row = rank * 4
        users = nnz if user_rows is None else user_rows
        items = nnz if item_rows is None else item_rows
        return int(nnz * (2 * row + 48) + items * (3 * row + 4)
                   + users * (2 * row + 4))
    if kernel != "plain":
        raise ValueError(f"kernel must be 'plain' or 'cuda', got {kernel!r}")
    return int(nnz * (4 * (rank // model_size) * factor_bytes + 16))


def dsgd_collective_bytes_per_sweep(nnz: int, rank: int,
                                    model_size: int = 1) -> int:
    """Wire bytes one DSGD sweep moves per rank for the rank reduction, as
    a ring all-reduce: the rank-sharded route sums ONE f32 prediction per
    rating over the model group, and a ring all-reduce of m ranks moves
    ``2·(m−1)/m`` bytes per reduced byte per rank. 0 at ``model_size`` 1
    (``rank`` is kept for the JAX package's signature; the sum does not
    depend on it)."""
    del rank
    if model_size <= 1:
        return 0
    return int(nnz * 4 * 2 * (model_size - 1) / model_size)


def dsgd_flops_per_sweep(nnz: int, rank: int) -> int:
    """FLOPs one full DSGD sweep computes: ~6·rank per rating visit (2·rank
    for the prediction dot, ~4·rank for the error broadcast and the two
    factor deltas)."""
    return int(nnz * 6 * rank)


def sgd_minibatch_update(
    U: torch.Tensor,
    V: torch.Tensor,
    u_rows: torch.Tensor,
    i_rows: torch.Tensor,
    values: torch.Tensor,
    weights: torch.Tensor,
    omega_u: torch.Tensor | None,
    omega_v: torch.Tensor | None,
    updater: Any,
    t: int,
    collision: str = "mean",
    inv_cu: torch.Tensor | None = None,
    inv_cv: torch.Tensor | None = None,
    pred_axis=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One minibatch, in place: gather → delta → scatter-add.

    Row collisions inside a minibatch:

    - ``collision="mean"``: each row's accumulated delta is divided by its
      occurrence count (``inv_cu``/``inv_cv`` are the precomputed per-entry
      1/count scales; without them the counts are taken here);
    - ``collision="sum"``: raw additive accumulation.

    ``pred_axis`` (a ``parallel.collectives.Axis``, the model group) is set
    when U and V hold rank slices: the local dot is then partial, and the
    prediction handed to the updater is its sum over the group; every other
    term (deltas, collision scales, scatter-add) is row-space and right on
    the slice as it is.
    """
    if collision not in ("mean", "sum"):
        raise ValueError(
            f"collision must be 'mean' or 'sum', got {collision!r}"
        )
    u_rows = u_rows.long()
    i_rows = i_rows.long()
    u = U[u_rows]
    v = V[i_rows]
    extra = {}
    if pred_axis is not None:
        extra["pred"] = group_sum(pred_axis, (u * v).sum(dim=-1))
    du, dv = updater.delta(
        values, u, v, weights=weights,
        omega_u=None if omega_u is None else omega_u[u_rows],
        omega_v=None if omega_v is None else omega_v[i_rows],
        t=t, **extra,
    )
    if collision == "mean":
        if inv_cu is not None:
            du = du * inv_cu[:, None]
            dv = dv * inv_cv[:, None]
        else:
            cu = torch.zeros(U.shape[0], dtype=U.dtype, device=U.device)
            cv = torch.zeros(V.shape[0], dtype=V.dtype, device=V.device)
            cu.index_add_(0, u_rows, weights)
            cv.index_add_(0, i_rows, weights)
            du = du / cu[u_rows].clamp_min(1.0)[:, None]
            dv = dv / cv[i_rows].clamp_min(1.0)[:, None]
    U.index_add_(0, u_rows, du)
    V.index_add_(0, i_rows, dv)
    return U, V


def sgd_block_sweep(
    U: torch.Tensor,
    V: torch.Tensor,
    u_rows: torch.Tensor,  # int[e] (e divisible by minibatch)
    i_rows: torch.Tensor,
    values: torch.Tensor,
    weights: torch.Tensor,
    omega_u: torch.Tensor | None,
    omega_v: torch.Tensor | None,
    updater: Any,
    t: int,
    minibatch: int,
    collision: str = "mean",
    inv_cu: torch.Tensor | None = None,
    inv_cv: torch.Tensor | None = None,
    pred_axis=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sweep one rating block (or one whole stratum, flattened) in
    minibatch chunks, in order, in place. ``pred_axis``: see
    ``sgd_minibatch_update``."""
    e = u_rows.shape[0]
    if e % minibatch:
        raise ValueError(
            f"block nnz {e} not divisible by minibatch {minibatch}")
    pre = inv_cu is not None
    for a in range(0, e, minibatch):
        sl = slice(a, a + minibatch)
        sgd_minibatch_update(
            U, V, u_rows[sl], i_rows[sl], values[sl], weights[sl],
            omega_u, omega_v, updater, t, collision,
            inv_cu[sl] if pre else None, inv_cv[sl] if pre else None,
            pred_axis,
        )
    return U, V


def dsgd_train(
    U: torch.Tensor,
    V: torch.Tensor,
    su: torch.Tensor,  # int[k, k, b] stratum-major user rows
    si: torch.Tensor,
    sv: torch.Tensor,
    sw: torch.Tensor,
    omega_u: torch.Tensor,
    omega_v: torch.Tensor,
    inv_cu: torch.Tensor | None = None,  # [k, k, b] precomputed collision
    inv_cv: torch.Tensor | None = None,  # scales (blocking.minibatch_inv_counts)
    *,
    updater: Any,
    minibatch: int,
    num_blocks: int,
    iterations: int,
    collision: str = "mean",
    t0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full single-device DSGD training loop.

    Superstep ``step`` visits stratum ``step mod k``; the schedule step is
    ``t = step // k + 1 + t0`` (``t0`` = sweeps already done, so segmented
    runs continue the schedule). The k blocks of a stratum are disjoint in
    users and items, so the stratum is swept as one flat block. Returns
    trained copies of ``U`` and ``V``.

    bf16 tables (the JAX XLA route's semantics): the whole call runs on
    one f32 upcast of each table and rounds back to bf16 once on exit.
    """
    store = U.dtype
    U = U.to(torch.float32, copy=True)
    V = V.to(torch.float32, copy=True)
    k = num_blocks
    b = su.shape[-1]
    flat = (k, k * b)
    su_f, si_f = su.reshape(flat), si.reshape(flat)
    sv_f, sw_f = sv.reshape(flat), sw.reshape(flat)
    icu_f = None if inv_cu is None else inv_cu.reshape(flat)
    icv_f = None if inv_cv is None else inv_cv.reshape(flat)
    for step in range(iterations * k):
        s = step % k
        t = step // k + 1 + int(t0)
        sgd_block_sweep(
            U, V, su_f[s], si_f[s], sv_f[s], sw_f[s], omega_u, omega_v,
            updater, t, minibatch, collision,
            None if icu_f is None else icu_f[s],
            None if icv_f is None else icv_f[s],
        )
    return U.to(store), V.to(store)


def online_train(
    U: torch.Tensor,
    V: torch.Tensor,
    u_rows: torch.Tensor,  # int[e], e divisible by minibatch
    i_rows: torch.Tensor,
    values: torch.Tensor,
    weights: torch.Tensor,
    *,
    updater: Any,
    minibatch: int,
    iterations: int = 1,
    collision: str = "mean",
    t0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Online micro-batch update: sweep one micro-batch ``iterations``
    times in minibatch chunks, without ω (regularized updaters fall back to
    plain λ). Sweep ``s`` (0-based) runs at schedule step ``t = t0 + s + 1``.

    The sweeps write in place, so this trains copies of ``U`` and ``V``
    (one copy of each per call, as the JAX route pays): tables a caller
    holds keep their values. Returns the trained copies."""
    U, V = U.clone(), V.clone()
    for s in range(iterations):
        sgd_block_sweep(U, V, u_rows, i_rows, values, weights, None, None,
                        updater, int(t0) + s + 1, minibatch, collision)
    return U, V


def pad_minibatches(u_rows, i_rows, values, minibatch: int):
    """Pad COO arrays (numpy) with weight-0 no-op entries to a power-of-2
    number of ``minibatch``-sized chunks: the divisibility contract of
    ``online_train``. Returns fresh ``(ur, ir, vals, w)`` int32/int32/
    float32/float32 numpy arrays of the padded length (fresh per call: a
    tensor made with ``torch.from_numpy`` shares their memory)."""
    n = len(u_rows)
    n_mb = max(1, -(-n // minibatch))
    padded = next_pow2(n_mb) * minibatch  # pow2 minibatch-count buckets
    ur = np.zeros(padded, np.int32)
    ir = np.zeros(padded, np.int32)
    vals_out = np.zeros(padded, np.float32)
    w = np.zeros(padded, np.float32)
    ur[:n], ir[:n], vals_out[:n], w[:n] = u_rows, i_rows, values, 1.0
    return ur, ir, vals_out, w


def predict_rows(U: torch.Tensor, V: torch.Tensor, u_rows: torch.Tensor,
                 i_rows: torch.Tensor) -> torch.Tensor:
    """Batched score r̂ = u·v, computed in float32."""
    return (U[u_rows].float() * V[i_rows].float()).sum(dim=-1)


def empirical_risk_rows(
    U: torch.Tensor,
    V: torch.Tensor,
    u_rows: torch.Tensor,
    i_rows: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    lambda_: float,
) -> torch.Tensor:
    """Σ over labeled points of residual² + λ(‖u‖² + ‖v‖²) — the norms are
    added once per rating occurrence."""
    u = U[u_rows].float()
    v = V[i_rows].float()
    res = values - (u * v).sum(dim=-1)
    per_point = res * res + lambda_ * ((u * u).sum(dim=-1)
                                       + (v * v).sum(dim=-1))
    return (per_point * mask).sum()


def sse_rows(
    U: torch.Tensor,
    V: torch.Tensor,
    u_rows: torch.Tensor,
    i_rows: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Masked sum of squared residuals (the RMSE numerator)."""
    res = values - predict_rows(U, V, u_rows, i_rows)
    return (res * res * mask).sum()
