"""The DSGD stratum sweep on Hopper (counterpart of
``large_scale_recommendation_tpu.ops.pallas_sgd``).

Two hand-written CUDA kernels (``csrc/dsgd_sweep.cu``) replace the JAX
package's Pallas kernels ``_sweep_kernel`` and ``_stratum_kernel``. One
stratum is ``n_mb`` minibatch steps; each step is two launches that cover
all k row-disjoint visits of the stratum at once:

- ``sgd_delta``   — ``sgd_delta_kernel``: gather, the λ/ω rule, du/dv into
  a ``[k, mb, r]`` f32 scratch;
- ``sgd_scatter`` — ``sgd_scatter_kernel``: atomic scatter-add of the
  scratch into U and V.

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
``LAUNCHES``) and uses its plain PyTorch version only for CPU tensors.
There is no fallback: a CUDA tensor either goes through the kernel or the
wrapper raises.

Beside them, the plain versions of the TPU kernels' own contracts, for the
tests and the on-card comparisons: ``block_sweep_reference`` (one visit,
block-local rows — ``pallas_block_sweep``) and ``stratum_sweep_reference``
(one stratum from ``build_stratum_operands``' visit-major operands —
``pallas_stratum_sweep``). Every plain version applies the one λ/ω rule
of ``RegularizedSGDUpdater.delta`` at a constant η; the two sweep
references run it through ``ops.sgd.sgd_block_sweep``, the CPU route of
``fit``. The TPU's VMEM/SMEM budget helpers have no
counterpart: the wrappers' shape checks take their place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.updaters import (
    RegularizedSGDUpdater,
    constant_lr,
)
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.ops._build import load_library

# launches per kernel since the last reset (counted where the kernel is
# launched, and nowhere else)
LAUNCHES = {"sgd_delta_kernel": 0, "sgd_scatter_kernel": 0}

_LIB = "dsgd_sweep"
_bound: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The built kernel library with its ctypes signatures declared."""
    global _bound
    if _bound is None:
        lib = load_library(_LIB)
        P, I64, I, F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
        lib.dsgd_sweep_max_rank.restype = I
        lib.dsgd_sweep_max_rank.argtypes = []
        lib.sgd_delta_launch.restype = I
        lib.sgd_delta_launch.argtypes = [P] * 12 + [I64, I64, I, I, I, F, F,
                                                     P]
        lib.sgd_scatter_launch.restype = I
        lib.sgd_scatter_launch.argtypes = [P] * 7 + [I64, I64, I, I, I, P]
        _bound = lib
    return _bound


def validate_cuda_contract(updater, collision: str, has_inv: bool):
    """The routing contract of the CUDA kernels: they inline the λ/ω
    RegularizedSGDUpdater rule and consume the precomputed collision
    scales (the same ValueError as the JAX package's
    ``validate_pallas_contract``)."""
    missing = [a for a in ("learning_rate", "lambda_", "schedule")
               if not hasattr(updater, a)]
    if missing or collision != "mean" or not has_inv:
        raise ValueError(
            "the CUDA kernels inline the λ/ω RegularizedSGDUpdater rule "
            "and the precomputed collision scales; they require an updater "
            f"with learning_rate/lambda_/schedule (missing: {missing}), "
            "collision_mode='mean' and precompute_collisions=True")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on one CUDA device or all on "
                     f"the CPU, got {sorted(kinds)}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_step(U, V, su_s, si_s, sw_s, du, dv, g, minibatch):
    k, b = su_s.shape
    rank = U.shape[-1]
    if U.dim() != 2 or V.dim() != 2 or V.shape[-1] != rank:
        raise ValueError(f"U {tuple(U.shape)} / V {tuple(V.shape)} must be "
                         "[rows, rank] with one rank")
    if b % minibatch or not 0 <= g < b // minibatch:
        raise ValueError(f"minibatch {g} of {minibatch} entries is outside "
                         f"a block of {b}")
    _check("U", U, torch.float32)
    _check("V", V, torch.float32)
    _check("su", su_s, torch.int32)
    _check("si", si_s, torch.int32, (k, b))
    _check("sw", sw_s, torch.float32, (k, b))
    _check("du", du, torch.float32, (k, minibatch, rank))
    _check("dv", dv, torch.float32, (k, minibatch, rank))
    return k, b, rank


def _rule(lr: float, lam: float) -> RegularizedSGDUpdater:
    """The λ/ω rule the kernels inline, at a constant η = ``lr``."""
    return RegularizedSGDUpdater(learning_rate=lr, lambda_=lam,
                                 schedule=constant_lr)


def sgd_delta_reference(U, V, su_s, si_s, sv_s, sw_s, icu_s, icv_s,
                        omega_u, omega_v, g, du, dv, *, lr, lam, minibatch):
    """Plain version of ``sgd_delta_kernel``: fills du/dv ``[k, mb, r]``
    for minibatch g of every visit of the stratum."""
    sl = slice(g * minibatch, (g + 1) * minibatch)
    ur = su_s[:, sl].reshape(-1).long()
    ir = si_s[:, sl].reshape(-1).long()
    d_u, d_v = _rule(lr, lam).delta(
        sv_s[:, sl].reshape(-1), U[ur], V[ir],
        weights=sw_s[:, sl].reshape(-1), omega_u=omega_u[ur],
        omega_v=omega_v[ir])
    du.copy_((d_u * icu_s[:, sl].reshape(-1, 1)).view(du.shape))
    dv.copy_((d_v * icv_s[:, sl].reshape(-1, 1)).view(dv.shape))
    return du, dv


def sgd_delta(U, V, su_s, si_s, sv_s, sw_s, icu_s, icv_s, omega_u, omega_v,
              g: int, du, dv, *, lr: float, lam: float, minibatch: int):
    """du/dv for minibatch ``g`` of all k visits of one stratum.

    ``su_s``/``si_s``/``sv_s``/``sw_s``/``icu_s``/``icv_s`` are the
    stratum's ``[k, b]`` planes of the stratum-major layout (global rows);
    ``du``/``dv`` the ``[k, mb, r]`` scratch. η (``lr``) is a runtime
    scalar."""
    if not _on_cuda(U, V, su_s, si_s, sv_s, sw_s, icu_s, icv_s, omega_u,
                    omega_v, du, dv):
        return sgd_delta_reference(U, V, su_s, si_s, sv_s, sw_s, icu_s,
                                   icv_s, omega_u, omega_v, g, du, dv,
                                   lr=lr, lam=lam, minibatch=minibatch)
    k, b, rank = _check_step(U, V, su_s, si_s, sw_s, du, dv, g, minibatch)
    for name, t in (("sv", sv_s), ("icu", icu_s), ("icv", icv_s)):
        _check(name, t, torch.float32, (k, b))
    _check("omega_u", omega_u, torch.float32, (U.shape[0],))
    _check("omega_v", omega_v, torch.float32, (V.shape[0],))
    lib = _lib()
    if rank > lib.dsgd_sweep_max_rank():
        raise ValueError(f"rank {rank} exceeds the kernel's "
                         f"{lib.dsgd_sweep_max_rank()}")
    stream = torch.cuda.current_stream(U.device).cuda_stream
    rc = lib.sgd_delta_launch(
        U.data_ptr(), V.data_ptr(), su_s.data_ptr(), si_s.data_ptr(),
        sv_s.data_ptr(), sw_s.data_ptr(), icu_s.data_ptr(), icv_s.data_ptr(),
        omega_u.data_ptr(), omega_v.data_ptr(), du.data_ptr(), dv.data_ptr(),
        b, g * minibatch, minibatch, rank, k, float(lr), float(lam), stream)
    if rc != 0:
        raise RuntimeError(f"sgd_delta_kernel launch failed: CUDA error {rc}")
    LAUNCHES["sgd_delta_kernel"] += 1
    return du, dv


def sgd_scatter_reference(U, V, su_s, si_s, sw_s, g, du, dv, *, minibatch):
    """Plain version of ``sgd_scatter_kernel``: ``index_add_`` of the
    real (weight ≠ 0) entries' deltas."""
    sl = slice(g * minibatch, (g + 1) * minibatch)
    rank = U.shape[-1]
    real = sw_s[:, sl].reshape(-1) != 0
    U.index_add_(0, su_s[:, sl].reshape(-1)[real].long(),
                 du.reshape(-1, rank)[real])
    V.index_add_(0, si_s[:, sl].reshape(-1)[real].long(),
                 dv.reshape(-1, rank)[real])
    return U, V


def sgd_scatter(U, V, su_s, si_s, sw_s, g: int, du, dv, *, minibatch: int):
    """Scatter-add minibatch ``g``'s du/dv into U and V, in place."""
    if not _on_cuda(U, V, su_s, si_s, sw_s, du, dv):
        return sgd_scatter_reference(U, V, su_s, si_s, sw_s, g, du, dv,
                                     minibatch=minibatch)
    k, b, rank = _check_step(U, V, su_s, si_s, sw_s, du, dv, g, minibatch)
    lib = _lib()
    stream = torch.cuda.current_stream(U.device).cuda_stream
    rc = lib.sgd_scatter_launch(
        U.data_ptr(), V.data_ptr(), su_s.data_ptr(), si_s.data_ptr(),
        sw_s.data_ptr(), du.data_ptr(), dv.data_ptr(), b, g * minibatch,
        minibatch, rank, k, stream)
    if rc != 0:
        raise RuntimeError(
            f"sgd_scatter_kernel launch failed: CUDA error {rc}")
    LAUNCHES["sgd_scatter_kernel"] += 1
    return U, V


def stratum_sweep(U, V, su, si, sv, sw, icu, icv, omega_u, omega_v,
                  s: int, du, dv, *, lr: float, lam: float,
                  minibatch: int):
    """Sweep stratum ``s`` (all k visits) in place: for each minibatch g,
    one ``sgd_delta`` and one ``sgd_scatter``. ``su``… are the full
    ``[k, k, b]`` stratum-major arrays."""
    n_mb = su.shape[-1] // minibatch
    planes = [a[s] for a in (su, si, sv, sw, icu, icv)]
    for g in range(n_mb):
        sgd_delta(U, V, *planes, omega_u, omega_v, g, du, dv, lr=lr,
                  lam=lam, minibatch=minibatch)
        sgd_scatter(U, V, planes[0], planes[1], planes[3], g, du, dv,
                    minibatch=minibatch)
    return U, V


def alloc_scratch(num_blocks: int, minibatch: int, rank: int,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``[k, mb, r]`` f32 du/dv scratch of one stratum step."""
    shape = (num_blocks, minibatch, rank)
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.float32, device=device))


def dsgd_train_cuda(
    U: torch.Tensor,  # f32[k*rpb_u, r]
    V: torch.Tensor,  # f32[k*rpb_v, r]
    su: torch.Tensor,  # int32[k, k, b] stratum-major GLOBAL user rows
    si: torch.Tensor,
    sv: torch.Tensor,
    sw: torch.Tensor,
    omega_u: torch.Tensor,  # f32[k*rpb_u]
    omega_v: torch.Tensor,
    icu: torch.Tensor,  # precomputed collision scales [k, k, b]
    icv: torch.Tensor,
    *,
    lr: float,
    lam: float,
    minibatch: int,
    num_blocks: int,
    iterations: int,
    schedule=None,
    t0: int = 0,
    scratch: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full DSGD training through the stratum-sweep kernels (counterpart of
    ``dsgd_train_pallas``; same positional layout as ``ops.sgd.dsgd_train``).

    Visit order: for each sweep, strata s = 0..k−1. The schedule is
    evaluated on the host once per sweep at ``t = sweep + 1 + t0`` and η
    enters the kernel as a runtime scalar (``schedule=None`` keeps η
    constant). ``scratch`` is the du/dv pair from ``alloc_scratch``
    (allocated here when absent). Returns trained copies of U and V.
    """
    k = num_blocks
    if int(U.shape[0]) % k or int(V.shape[0]) % k:
        raise ValueError(
            f"table rows ({U.shape[0]}, {V.shape[0]}) must be divisible "
            f"by num_blocks={k} — use the data.blocking layout")
    if tuple(su.shape[:2]) != (k, k) or su.shape[-1] % minibatch:
        raise ValueError(f"su shape {tuple(su.shape)} is not [{k}, {k}, b] "
                         f"with b a multiple of {minibatch}")
    for name, idx, rows in (("su", su, U.shape[0]), ("si", si, V.shape[0])):
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= rows):
            raise ValueError(f"{name} holds rows outside [0, {rows})")
    U = U.clone()
    V = V.clone()
    du, dv = scratch if scratch is not None else alloc_scratch(
        k, minibatch, int(U.shape[-1]), U.device)
    for sweep in range(iterations):
        t = sweep + 1 + int(t0)
        lr_t = (float(np.float32(lr)) if schedule is None
                else schedule(lr, t))
        for s in range(k):
            stratum_sweep(U, V, su, si, sv, sw, icu, icv, omega_u, omega_v,
                          s, du, dv, lr=lr_t, lam=lam, minibatch=minibatch)
    return U, V


# -- plain versions of the TPU kernels' own contracts -----------------------


def build_stratum_operands(su, si, sv, sw, icu, icv, omega_u, omega_v,
                           *, num_blocks: int, rpb_u: int, rpb_v: int,
                           minibatch: int):
    """The visit-major operand layout of ``pallas_stratum_sweep`` from the
    stratum-major arrays: block-LOCAL row indices ``idx [k², 2, b]`` and
    the stacked per-entry streams ``streams [k², rows6, mb]`` (vals, w,
    icu, icv, ω_u, ω_v, each ``n_mb`` rows, padded to a multiple of 8).
    Weight-0 padding entries carry global row 0, a negative local row for
    blocks p > 0: it is clamped to 0, as in the JAX package."""
    k = num_blocks
    b = int(su.shape[-1])
    n_mb = b // minibatch
    dev = su.device
    p_arr = torch.arange(k, dtype=torch.int64, device=dev)
    q_arr = (p_arr[None, :] + p_arr[:, None]) % k
    ur_l = (su.long() - (p_arr * rpb_u)[None, :, None]).clamp_min(0)
    ir_l = (si.long() - (q_arr * rpb_v)[:, :, None]).clamp_min(0)
    idx = torch.stack([ur_l.reshape(k * k, b), ir_l.reshape(k * k, b)],
                      dim=1).to(torch.int32)
    ou_e = omega_u.float()[su.long()]
    ov_e = omega_v.float()[si.long()]
    streams = torch.stack([a.float() for a in (sv, sw, icu, icv, ou_e, ov_e)],
                          dim=2)  # [k, k, 6, b]
    streams = streams.reshape(k * k, 6 * n_mb, minibatch)
    rows6 = -(-6 * n_mb // 8) * 8
    if rows6 != 6 * n_mb:
        streams = torch.nn.functional.pad(
            streams, (0, 0, 0, rows6 - 6 * n_mb))
    return idx, streams


def block_sweep_reference(U_blk, V_blk, ur_local, ir_local, vals, w, icu, icv,
                          omega_u, omega_v, *, lr: float, lam: float,
                          minibatch: int):
    """Plain version of ``pallas_block_sweep`` (``_sweep_kernel``): sweep one
    rating block against its block-local U/V row slices and ω. Returns
    updated copies."""
    Ub, Vb = U_blk.clone(), V_blk.clone()
    return sgd_ops.sgd_block_sweep(
        Ub, Vb, ur_local, ir_local, vals, w, omega_u, omega_v,
        _rule(lr, lam), 1, minibatch, "mean", icu, icv)


def _block_omega(rows, omega_e, w, rpb):
    """A block's ω slice from the per-entry ω stream: every real entry of a
    row carries that row's ω (padding entries carry another block's)."""
    real = w != 0
    out = torch.zeros(rpb, dtype=omega_e.dtype, device=omega_e.device)
    out[rows[real].long()] = omega_e[real]
    return out


def stratum_sweep_reference(U, V, idx, streams, s: int, *, lr: float,
                            lam: float, minibatch: int, num_blocks: int):
    """Plain version of ``pallas_stratum_sweep`` (``_stratum_kernel``):
    visits p = 0..k−1 of stratum ``s`` in order (U block p, V block
    (p+s) mod k), from ``build_stratum_operands``' layout. Returns updated
    copies."""
    k = num_blocks
    rpb_u = U.shape[0] // k
    rpb_v = V.shape[0] // k
    n_mb = idx.shape[-1] // minibatch
    U, V = U.clone(), V.clone()
    for p in range(k):
        q = (p + s) % k
        vrow = s * k + p
        vals, w, icu, icv, ou_e, ov_e = (
            streams[vrow, c * n_mb:(c + 1) * n_mb].reshape(-1)
            for c in range(6))
        ur, ir = idx[vrow, 0], idx[vrow, 1]
        # in place on the visit's row slices of the copies
        sgd_ops.sgd_block_sweep(
            U[p * rpb_u:(p + 1) * rpb_u], V[q * rpb_v:(q + 1) * rpb_v],
            ur, ir, vals, w, _block_omega(ur, ou_e, w, rpb_u),
            _block_omega(ir, ov_e, w, rpb_v), _rule(lr, lam), 1, minibatch,
            "mean", icu, icv)
    return U, V
