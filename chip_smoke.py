#!/usr/bin/env python3
"""Run the PyTorch port's DSGD training path on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:

1. device   — the card's name and power limit (nvidia-smi), CUDA device name;
2. build    — nvcc builds csrc/dsgd_sweep.cu (sm_90a) from the checkout;
3. kernels  — the stratum sweep through the kernels against its plain
              PyTorch version on the card: a small k=4, rank-128 problem
              with duplicate rows and padding (one stratum, 3 sweeps), and
              one stratum at the full bench geometry; max-abs ≤ 1e-5 per
              stratum (atomic scatter order);
4. main     — the bench configuration at full width: ML-25M-shaped ratings
              (162,541 × 59,047, 25,000,095 ratings, 95/5 split), k=8 Gemulla
              strata, rank 128, minibatch 32,768, warm_boost schedule, 3
              sweeps through ``DSGD().fit`` on the card; the host steps
              before the first sweep (collision scales, factor init,
              host→device copies) are timed apart, and the sweeps inside
              ``fit`` with CUDA events (``DSGD.segment_ms``); holdout RMSE
              after every sweep must be finite and fall, every stratum step
              must have launched both kernels, and the same 3 sweeps
              through the plain route on the card must end within 1e-4 of
              its RMSE;
5. timing   — each kernel against its plain version at the main path's
              shapes (CUDA events), with its share of the bound of one
              stratum step on this card.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.updaters import (
    RegularizedSGDUpdater,
    schedule_from_name,
)
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data.movielens import synthetic_like
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.ops import _build, cuda_sgd
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops

# published H100 SXM peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SOURCE = "large_scale_recommendation_tpu_torch/csrc/dsgd_sweep.cu"
# the pair replaces the stratum kernel on the main path (and, by the same
# launches, the per-visit _sweep_kernel at pallas_sgd.py:172)
REPLACES = "large_scale_recommendation_tpu/ops/pallas_sgd.py:440"
# the bench configuration (bench.py:190-202), 3 sweeps
BENCH = dict(num_factors=128, lambda_=0.1, iterations=3, learning_rate=0.3,
             lr_schedule="warm_boost", seed=0, minibatch_size=32768,
             init_scale=0.08, collision_mode="mean", minibatch_sort="item")
K = 8
RMSE_TARGET = 0.155
STRATUM_TOL = 1e-5  # max-abs per stratum: atomics add duplicates in any order


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_args(problem, icu, icv, dev):
    """The stratum-major arrays on the card, in ``dsgd_train`` order."""
    r = problem.ratings

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    return (put(r.u_rows, torch.int32), put(r.i_rows, torch.int32),
            put(r.values, torch.float32), put(r.weights, torch.float32),
            put(problem.users.omega, torch.float32),
            put(problem.items.omega, torch.float32),
            put(icu, torch.float32), put(icv, torch.float32))


def stratum_operands(args, problem, minibatch):
    su, si, sv, sw, ou, ov, icu, icv = args
    return cuda_sgd.build_stratum_operands(
        su, si, sv, sw, icu, icv, ou, ov, num_blocks=problem.ratings.num_blocks,
        rpb_u=problem.users.rows_per_block,
        rpb_v=problem.items.rows_per_block, minibatch=minibatch)


def max_abs(pairs) -> float:
    return max(float((a - b).abs().max()) for a, b in pairs)


def check_strata(U, V, args, problem, minibatch, lr, lam, label):
    """Kernel vs plain for every stratum of one sweep, each from the same
    tables; returns the largest max-abs difference."""
    k = problem.ratings.num_blocks
    su, si, sv, sw, ou, ov, icu, icv = args
    idx, streams = stratum_operands(args, problem, minibatch)
    du, dv = cuda_sgd.alloc_scratch(k, minibatch, U.shape[-1], U.device)
    worst = 0.0
    for s in range(k):
        Uk, Vk = U.clone(), V.clone()
        cuda_sgd.stratum_sweep(Uk, Vk, su, si, sv, sw, icu, icv, ou, ov, s,
                               du, dv, lr=lr, lam=lam, minibatch=minibatch)
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            U, V, idx, streams, s, lr=lr, lam=lam, minibatch=minibatch,
            num_blocks=k)
        torch.cuda.synchronize()
        err = max_abs([(Uk, Ur), (Vk, Vr)])
        if not (err <= STRATUM_TOL and torch.isfinite(Uk).all()):
            raise AssertionError(f"{label}: stratum {s} max-abs {err:.3e} > "
                                 f"{STRATUM_TOL:.0e}")
        worst = max(worst, err)
    return worst


def phase_small(dev):
    """k=4, rank 128, skewed ids (duplicate rows inside minibatches) and
    weight-0 block padding."""
    gen = SyntheticMFGenerator(num_users=2000, num_items=1500, rank=16,
                               noise=0.1, seed=3, skew_lam=2.0)
    train = gen.generate(60_000)
    mb, k, rank, lam = 1024, 4, 128, 0.1
    problem = blocking.block_problem(train, num_blocks=k, seed=0,
                                     minibatch_multiple=mb)
    args = device_args(problem,
                       *blocking.minibatch_inv_counts(problem.ratings, mb),
                       dev)
    sw = problem.ratings.weights
    g = torch.Generator(device=dev).manual_seed(0)
    U = 0.08 * torch.rand((problem.users.num_rows, rank), generator=g,
                          device=dev)
    V = 0.08 * torch.rand((problem.items.num_rows, rank), generator=g,
                          device=dev)
    one = check_strata(U, V, args, problem, mb, 0.75, lam, "small")
    sched = schedule_from_name("warm_boost", lam)
    Uk, Vk = cuda_sgd.dsgd_train_cuda(U, V, *args, lr=0.3, lam=lam,
                                      minibatch=mb, num_blocks=k,
                                      iterations=3, schedule=sched)
    idx, streams = stratum_operands(args, problem, mb)
    Ur, Vr = U, V
    for sweep in range(3):
        for s in range(k):
            Ur, Vr = cuda_sgd.stratum_sweep_reference(
                Ur, Vr, idx, streams, s, lr=sched(0.3, sweep + 1), lam=lam,
                minibatch=mb, num_blocks=k)
    torch.cuda.synchronize()
    err3 = max_abs([(Uk, Ur), (Vk, Vr)])
    if not err3 <= STRATUM_TOL * 3 * k:
        raise AssertionError(f"small: 3 sweeps max-abs {err3:.3e}")
    say("kernels.small", k=k, rank=rank, minibatch=mb,
        pad_fraction=round(float((sw == 0).mean()), 4),
        one_stratum_max_abs=f"{one:.3e}", three_sweeps_max_abs=f"{err3:.3e}",
        tol_per_stratum=STRATUM_TOL)


class HoldoutEval:
    """Segment hook of ``DSGD``: holdout RMSE of the live tables after each
    sweep (the rows come from the same deterministic blocking fit runs)."""

    def __init__(self, problem, holdout, dev):
        ru, ri, rv, rw = holdout.to_numpy()
        u_rows, u_mask = problem.users.rows_for(ru)
        i_rows, i_mask = problem.items.rows_for(ri)
        mask = (u_mask * i_mask * rw).astype(np.float32)
        self.n = float(mask.sum())
        self.rows = [torch.as_tensor(a).to(dev)
                     for a in (u_rows, i_rows, rv, mask)]
        self.rmse: list[float] = []

    def on_segment(self, U, V, label, step):
        sse = float(sgd_ops.sse_rows(U, V, *self.rows))
        self.rmse.append(math.sqrt(sse / self.n))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.load_library("dsgd_sweep")
    say("build", seconds=round(time.perf_counter() - t0, 2))
    for line in _build.nvcc_output.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    phase_small(dev)

    # -- main path data: bench.py's host pipeline --------------------------
    t0 = time.perf_counter()
    train, holdout = synthetic_like("ml-25m", rank=16, noise=0.1, seed=0,
                                    skew_lam=2.0)
    gen_s = time.perf_counter() - t0
    cfg = DSGDConfig(**BENCH)
    mb = cfg.minibatch_size
    t0 = time.perf_counter()
    problem = blocking.block_problem(train, num_blocks=K, seed=cfg.seed,
                                     minibatch_multiple=mb,
                                     minibatch_sort=cfg.minibatch_sort)
    block_s = time.perf_counter() - t0
    b = problem.ratings.u_rows.shape[-1]
    n_mb = b // mb
    say("data", train=train.n, holdout=holdout.n,
        users=problem.users.num_rows, items=problem.items.num_rows,
        rows_per_block=f"{problem.users.rows_per_block}/"
                       f"{problem.items.rows_per_block}",
        block_nnz=b, n_mb=n_mb, max_pad_ratio=round(
            problem.ratings.max_pad_ratio, 4),
        gen_wall_s=round(gen_s, 2), blocking_wall_s=round(block_s, 2))
    t0 = time.perf_counter()
    icu, icv = blocking.minibatch_inv_counts(problem.ratings, mb)
    inv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    U0, V0 = DSGD(cfg)._init_factors(problem)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = device_args(problem, icu, icv, dev)
    U0, V0 = U0.to(dev), V0.to(dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    # the same host steps fit runs before its first sweep, timed apart
    say("host", inv_counts_wall_s=inv_s, init_factors_wall_s=init_s,
        host_to_device_wall_s=copy_s,
        host_to_device_bytes=sum(a.nbytes for a in args)
        + U0.nbytes + V0.nbytes)
    lam = cfg.lambda_
    sched = schedule_from_name(cfg.lr_schedule, lam)
    full = check_strata(U0, V0, args, problem, mb, sched(cfg.learning_rate, 1),
                        lam, "full")
    say("kernels.full", k=K, rank=cfg.num_factors, minibatch=mb,
        one_stratum_max_abs=f"{full:.3e}", tol_per_stratum=STRATUM_TOL)

    # -- the main path: DSGD().fit on the card --------------------------------
    solver = DSGD(cfg)
    solver.evaluator = HoldoutEval(problem, holdout, dev)
    torch.cuda.synchronize()
    cuda_sgd.reset_launch_counts()
    t0 = time.perf_counter()
    model = solver.fit(train, num_blocks=K, checkpoint_every=1)
    rmse = model.rmse(holdout)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(cuda_sgd.LAUNCHES)
    curve = solver.evaluator.rmse
    sweep_ms = solver.segment_ms  # one segment = one sweep, inside fit
    nnz = problem.ratings.nnz
    say("main.fit", wall_s=round(fit_s, 2), sweep_ms=sweep_ms,
        ratings_per_s=nnz * len(sweep_ms) / (sum(sweep_ms) / 1e3),
        rmse_per_sweep=curve, rmse=rmse, launches=launches)
    if not all(math.isfinite(x) for x in curve) or len(curve) != 3:
        raise AssertionError(f"holdout RMSE curve {curve}")
    if not all(b_ < a_ for a_, b_ in zip(curve, curve[1:])):
        raise AssertionError(f"holdout RMSE did not fall every sweep: {curve}")
    if abs(rmse - curve[-1]) > 1e-6:
        raise AssertionError(f"model.rmse {rmse} != last sweep {curve[-1]}")
    if len(sweep_ms) != cfg.iterations:
        raise AssertionError(f"fit timed {len(sweep_ms)} sweeps")
    want = n_mb * K * cfg.iterations
    if (launches["sgd_delta_kernel"] != want
            or launches["sgd_scatter_kernel"] != want):
        raise AssertionError(f"launches {launches}, expected {want} each "
                             f"(2·n_mb·k·iterations = {2 * want} in all)")
    if tuple(model.U.shape) != (problem.users.num_rows, cfg.num_factors):
        raise AssertionError(f"U shape {tuple(model.U.shape)}")

    # -- the same 3 sweeps on the plain route, and through the kernels again,
    # from the same initial tables (for the comparison only) ---------------
    def replay(step):
        U, V, out = U0, V0, []
        for sweep in range(cfg.iterations):
            a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            U, V = step(U, V, sweep)
            e.record()
            e.synchronize()
            out.append(a.elapsed_time(e))
        ev = solver.evaluator
        return out, math.sqrt(float(sgd_ops.sse_rows(U, V, *ev.rows)) / ev.n)

    scratch = cuda_sgd.alloc_scratch(K, mb, cfg.num_factors, dev)
    upd = RegularizedSGDUpdater(learning_rate=cfg.learning_rate, lambda_=lam,
                                schedule=sched)
    replay_ms, rmse_replay = replay(lambda U, V, sweep: cuda_sgd.dsgd_train_cuda(
        U, V, *args, lr=cfg.learning_rate, lam=lam, minibatch=mb,
        num_blocks=K, iterations=1, schedule=sched, t0=sweep,
        scratch=scratch))
    plain_ms, rmse_plain = replay(lambda U, V, sweep: sgd_ops.dsgd_train(
        U, V, *args, updater=upd, minibatch=mb, num_blocks=K, iterations=1,
        t0=sweep))
    say("main.replay", kernel_ms=replay_ms, plain_ms=plain_ms,
        model_bytes_per_sweep=sgd_ops.dsgd_bytes_per_sweep(
            nnz, cfg.num_factors, kernel="cuda"),
        rmse_kernel_replay=rmse_replay, rmse_plain=rmse_plain)
    if not abs(rmse_plain - rmse) <= 1e-4:
        raise AssertionError(f"plain route RMSE {rmse_plain} vs kernel "
                             f"{rmse}: differ by more than 1e-4")
    say("main.target", rmse=rmse, target=RMSE_TARGET,
        reached=rmse <= RMSE_TARGET)

    kernels = time_kernels(U0, V0, args, problem, mb, lam, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def time_kernels(U0, V0, args, problem, mb, lam, launches):
    """Each kernel against its plain version on stratum 0, minibatch 0 of
    the main path (k visits × mb entries), with its bound from this data."""
    su, si, sv, sw, ou, ov, icu, icv = args
    k = problem.ratings.num_blocks
    rank = U0.shape[-1]
    s, g = 0, 0
    planes = [a[s] for a in (su, si, sv, sw, icu, icv)]
    lr = schedule_from_name("warm_boost", lam)(0.3, 1)
    dk = cuda_sgd.alloc_scratch(k, mb, rank, U0.device)
    dp = cuda_sgd.alloc_scratch(k, mb, rank, U0.device)

    def delta(fn, d):
        return lambda: fn(U0, V0, *planes, ou, ov, g, *d, lr=lr, lam=lam,
                          minibatch=mb)

    delta(cuda_sgd.sgd_delta, dk)()
    delta(cuda_sgd.sgd_delta_reference, dp)()
    torch.cuda.synchronize()
    delta_err = max_abs([(dk[0], dp[0]), (dk[1], dp[1])])
    delta_ms = cuda_ms(delta(cuda_sgd.sgd_delta, dk), reps=20)
    delta_plain_ms = cuda_ms(delta(cuda_sgd.sgd_delta_reference, dp), reps=5)

    Uk, Vk, Up, Vp = U0.clone(), V0.clone(), U0.clone(), V0.clone()
    cuda_sgd.sgd_scatter(Uk, Vk, planes[0], planes[1], planes[3], g, *dp,
                         minibatch=mb)
    cuda_sgd.sgd_scatter_reference(Up, Vp, planes[0], planes[1], planes[3],
                                   g, *dp, minibatch=mb)
    torch.cuda.synchronize()
    scatter_err = max_abs([(Uk, Up), (Vk, Vp)])
    scatter_ms = cuda_ms(lambda: cuda_sgd.sgd_scatter(
        Uk, Vk, planes[0], planes[1], planes[3], g, *dp, minibatch=mb),
        reps=20)
    scatter_plain_ms = cuda_ms(lambda: cuda_sgd.sgd_scatter_reference(
        Up, Vp, planes[0], planes[1], planes[3], g, *dp, minibatch=mb),
        reps=5)
    ur = planes[0][:, :mb].reshape(-1).long()
    ir = planes[1][:, :mb].reshape(-1).long()
    du_flat, dv_flat = dp[0].reshape(-1, rank), dp[1].reshape(-1, rank)
    # one index_add_ per table: padding rows add exact zeros
    lib_ms = cuda_ms(lambda: (Up.index_add_(0, ur, du_flat),
                              Vp.index_add_(0, ir, dv_flat)), reps=20)

    # bounds from this step's data. The ported function is the whole step
    # (both kernels): it reads each distinct row once with its ω and 24 B of
    # streams per entry, and writes each distinct row back once. The delta
    # kernel's share is the reads, the scatter kernel's the writes; their
    # sum is the step's bound. The du/dv scratch round trip is a cost of the
    # two-launch design, reported apart and in neither bound.
    real = planes[3][:, :mb].reshape(-1) != 0
    n_real = int(real.sum())
    n_all = k * mb
    uniq_u = int(torch.unique(ur[real]).numel())
    uniq_v = int(torch.unique(ir[real]).numel())
    row = rank * 4
    d_bytes = (uniq_u + uniq_v) * (row + 4) + n_all * 24
    s_bytes = (uniq_u + uniq_v) * row
    d_flops = n_real * 10 * rank
    s_flops = n_real * 2 * rank
    scratch_bytes = 2 * 2 * n_all * row  # du/dv written, then read back

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    step_bms, _ = bound(d_bytes + s_bytes, d_flops + s_flops)
    step_ms = delta_ms + scatter_ms
    out = []
    for name, err, ms, pms, (bms, by), lib in (
            ("sgd_delta_kernel", delta_err, delta_ms, delta_plain_ms,
             bound(d_bytes, d_flops), None),
            ("sgd_scatter_kernel", scatter_err, scatter_ms, scatter_plain_ms,
             bound(s_bytes, s_flops), lib_ms)):
        if not err <= STRATUM_TOL:
            raise AssertionError(f"{name} max-abs {err:.3e} vs plain")
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES,
                    "launches": launches[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": pms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib,
                    "step_ms": step_ms, "step_bound_ms": step_bms})
    say("kernels.timing", visits=k, minibatch=mb, real_entries=n_real,
        distinct_u=uniq_u, distinct_v=uniq_v,
        function_bytes=d_bytes + s_bytes, scratch_bytes=scratch_bytes,
        step_ms=step_ms, step_bound_ms=step_bms,
        step_share_of_bound=step_bms / step_ms)
    return out


if __name__ == "__main__":
    sys.exit(main())
