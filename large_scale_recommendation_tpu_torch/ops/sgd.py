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
in place: ``dsgd_train`` copies its input tables once and returns the
trained copies.
"""

from __future__ import annotations

from typing import Any

import torch


def dsgd_bytes_per_sweep(nnz: int, rank: int, *, kernel: str = "plain",
                         factor_bytes: int = 4) -> int:
    """Bytes of device-memory traffic one full DSGD sweep moves, per route
    (a model of each route's design, not the function's bound: that counts
    distinct rows once per step and depends on the data).

    - ``kernel="plain"`` (the gather route): every rating pays ~4 row
      transactions (read+write of a u row and a v row) of
      ``rank × factor_bytes`` plus ~16 B of COO stream.
    - ``kernel="cuda"`` (``csrc/dsgd_sweep.cu``): 2 row gathers + 2 row
      read-modify-writes + the f32 du/dv scratch written by the delta
      kernel and read back by the scatter kernel (10 rows of traffic per
      rating), plus 24 B of per-entry streams.
    """
    if kernel == "cuda":
        return int(nnz * (6 * rank * factor_bytes + 4 * rank * 4 + 24))
    if kernel != "plain":
        raise ValueError(f"kernel must be 'plain' or 'cuda', got {kernel!r}")
    return int(nnz * (4 * rank * factor_bytes + 16))


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """One minibatch, in place: gather → delta → scatter-add.

    Row collisions inside a minibatch:

    - ``collision="mean"``: each row's accumulated delta is divided by its
      occurrence count (``inv_cu``/``inv_cv`` are the precomputed per-entry
      1/count scales; without them the counts are taken here);
    - ``collision="sum"``: raw additive accumulation.
    """
    if collision not in ("mean", "sum"):
        raise ValueError(
            f"collision must be 'mean' or 'sum', got {collision!r}"
        )
    u_rows = u_rows.long()
    i_rows = i_rows.long()
    u = U[u_rows]
    v = V[i_rows]
    du, dv = updater.delta(
        values, u, v, weights=weights,
        omega_u=None if omega_u is None else omega_u[u_rows],
        omega_v=None if omega_v is None else omega_v[i_rows],
        t=t,
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sweep one rating block (or one whole stratum, flattened) in
    minibatch chunks, in order, in place."""
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
    """
    U = U.clone()
    V = V.clone()
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
    return U, V


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
