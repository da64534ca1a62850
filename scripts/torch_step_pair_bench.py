#!/usr/bin/env python3
"""Time variants of the PyTorch port's DSGD step pair (kernel A,
``sgd_item_rows_kernel``; kernel B, ``sgd_user_rows_kernel``; both in
``large_scale_recommendation_tpu_torch/csrc/dsgd_sweep.cu``) against each
other on one NVIDIA GPU, on the main path's data.

    python3 scripts/torch_step_pair_bench.py [--variants current,no_keep]
        [--parent DIR] [--yardstick] [--bf16] [--out step_pair.jsonl]

Each variant is a text of the kernel source: ``current`` is the checkout's
file, ``parent`` the same file under ``--parent DIR`` (an unpacked earlier
commit), and the other names are edits of the current file listed in
``EDITS`` (an L2 eviction priority changed, another ring depth or
ownership width); ``rows_plan`` runs the current source on a step plan
ordered by row alone (``cuda_sgd._visit_order`` giving every visit the
same rank), the earlier layout. All variants build at once (nvcc, the
flags of ``ops/_build.py``, ``-Xptxas -v``), each into its own library,
bound in turn in place of the package's. The data is ``chip_smoke.py``'s
main path: the ML-25M-shaped bench problem (162,541 × 59,047, 25M
ratings, host blocking), k 8, rank 128, minibatch 32,768, its step plan
and keyed initial tables.

The variants run in the order given, then in reverse (A B C C B A), and
each run prints one JSON line (and appends it to ``--out``):
- ``max_abs``: stratum 0 through the variant against
  ``stratum_sweep_reference`` (must be ≤ 1e-5), and ``tables_sha256``, the
  first 16 hex digits of the SHA-256 of its tables (equal digests: two
  variants' tables bit-equal);
- ``a_ms`` / ``b_ms``: step 0 warm, 20 launches of each kernel (CUDA
  events), as ``chip_smoke.py``'s ``[kernels.timing]``;
- ``stratum_a_ms`` / ``stratum_b_ms``: each kernel's mean over the 12
  steps of stratum 0, the pair alternating as on the main path (best of
  3 passes);
- ``cold_a_ms`` / ``cold_b_ms``: step 0 after a 128 MB write and read
  (the L2 holds none of the step's rows; medians of 10);
- the card's name and power limit (``nvidia-smi``), the registers of each
  variant's rank-128 kernels (from ``-Xptxas -v``) and, where the source
  has ``dsgd_step_kernel_attrs``, shared memory and resident blocks.

With ``--yardstick``, one more line: what the card sustains for the step's
own row traffic without the kernels, on step 0's distinct U (then V) rows
in the order kernel B (A) walks them: ``index_select`` into a packed
buffer (random 512-byte row reads, contiguous writes) and ``index_copy_``
back (contiguous reads, random row writes), and three one-warp-a-row
kernels of ``YARDSTICK_CU`` — each row read, each row written, each row
read and written back in place (the device-memory traffic kernel B must
make) — each with its ms and GB/s (bytes read + written over the time).
Variants whose name starts with ``diag_`` change what a kernel computes
(timing only): their ``max_abs`` is reported, not held to 1e-5.

With ``--bf16``, the two bf16 routes through each variant but ``parent``
(in the same order, then in reverse), stratum 0 of the same data on bf16
tables: ``cast`` (``cuda_sgd.stratum_sweep_cast``:
both whole tables upcast, the f32 pair, both rounded back) against
``flagged`` (``stratum_sweep(..., store=)``: the pair reads each row from
the bf16 table at its first step of the stratum and writes it back at its
last), first checked bit-equal, then run cast, flagged, flagged, cast, one
JSON line each: the stratum's ms warm (best of 3, CUDA events, every
launch of the route inside) and from a cold L2 (a 128 MB write and read
before each of 5 repetitions; median), each beside the bound of the
function both routes compute (``chip_smoke.stratum_bound_ms``: the
stratum's f32 step bounds, each row's first read and last write at 2 B a
column in bf16). Then one line of the plan's build: the whole
``build_step_plan`` and its touch flags alone (``touch_flags`` of both
sides over the plan's entries), best of 3 each, synchronized wall.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from large_scale_recommendation_tpu_torch.core.updaters import (  # noqa: E402
    schedule_from_name,
)
from large_scale_recommendation_tpu_torch.data import blocking  # noqa: E402
from large_scale_recommendation_tpu_torch.data.movielens import (  # noqa: E402
    synthetic_like,
)
from large_scale_recommendation_tpu_torch.models.dsgd import (  # noqa: E402
    DSGD,
    DSGDConfig,
)
from large_scale_recommendation_tpu_torch.ops import _build, cuda_sgd  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "dsgd_sweep.cu")
# text edits of the current source: (old, new) pairs, each must match
ONCE = 'L2::evict_normal.b64 %0, 1.0;" : "=l"(p.once)'
EDITS = {
    "no_keep": [("L2::evict_last", "L2::evict_normal")],
    "once_first": [(ONCE, ONCE.replace("evict_normal", "evict_first"))],
    "stages4": [("constexpr int kStages = 8;", "constexpr int kStages = 4;")],
    "stages12": [("constexpr int kStages = 8;",
                  "constexpr int kStages = 12;")],
    "own32": [("constexpr int kOwn = 16;", "constexpr int kOwn = 32;")],
    "own8": [("constexpr int kOwn = 16;", "constexpr int kOwn = 8;")],
    # timing only: kernel B stores no U row
    "diag_b_no_store": [
        ("""        put_row<W, NCH, H>(U + (int64_t)cur * rank, U16 + (int64_t)cur * rank,
                           cur_last, acc, lane, rank, pol.once);""", ";"),
        ("""  put_row<W, NCH, H>(U + (int64_t)cur * rank, U16 + (int64_t)cur * rank,
                     cur_last, acc, lane, rank, pol.once);
}""", "}")],
    # timing only: each segment's old row read from the first 4,096 rows
    # of its table (2 MB, L2-resident), in both kernels
    "diag_old_rows_l2": [(
        "src = olds + (int64_t)sm.starts[f.o].row * rank;",
        "src = olds + (int64_t)(sm.starts[f.o].row % 4096) * rank;")],
    # timing only: each gathered row (A's U rows, B's snapshot rows) from
    # the first 4,096 rows of its table
    "diag_gathers_l2": [(
        "src = gathered + (int64_t)sm.entries[f.o].gather * rank;",
        "src = gathered + (int64_t)(sm.entries[f.o].gather % 4096) * rank;")],
    # kernel A's V rows (old-row reads and write-back) evict last in place
    # of its U gathers: V (30 MB at the bench) may stay from step to step
    "keep_v": [
        (f"V, V16, touch.firsts, pol.once, U, U16,\n{pad}pol.keep,",
         f"V, V16, touch.firsts, pol.keep, U, U16,\n{pad}pol.once,")
        for pad in (" " * 18, " " * 20)] + [
        (f"V16 + (int64_t)cur * rank,\n{pad}cur_last, acc, lane, rank, "
         "pol.once);",
         f"V16 + (int64_t)cur * rank,\n{pad}cur_last, acc, lane, rank, "
         "pol.keep);") for pad in (" " * 27, " " * 21)],
    # the snapshot (A's writes, B's gathers) at the normal priority
    "snap_once": [
        ("store_row<W, NCH>(snap + (int64_t)cur * rank, vcur, lane, rank,\n"
         "                          pol.keep);",
         "store_row<W, NCH>(snap + (int64_t)cur * rank, vcur, lane, rank,\n"
         "                          pol.once);"),
        ("store_row<W, NCH>(snap + (int64_t)cur * rank, vcur, lane, rank, "
         "pol.keep);",
         "store_row<W, NCH>(snap + (int64_t)cur * rank, vcur, lane, rank, "
         "pol.once);")] + [
        ("snap, nullptr, pol.keep,", "snap, nullptr, pol.once,")],
    # bf16 rows (the flagged route) copied as 16-byte chunks of 8 columns
    # by half the lanes where rank % 8 == 0 and the row is 16-byte aligned,
    # a lane then reading what its neighbour copied (a __syncwarp first)
    "wide16": [
        ("""#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = col<W>(j, lane);
      if (c >= rank) continue;
      if constexpr (W == 4)  // this lane's 4 columns at 2·c bytes""",
         """if (W == 4 && rank % 8 == 0
        && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
      if (8 * lane < rank)
        copy_async<4>(slot + 4 * lane,
                      reinterpret_cast<const float*>(row + 8 * lane), pol);
    } else {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = col<W>(j, lane);
      if (c >= rank) continue;
      if constexpr (W == 4)  // this lane's 4 columns at 2·c bytes"""),
        ("        slot[c] = bf16_bits_to_f32(row[c]);\n    }\n",
         "        slot[c] = bf16_bits_to_f32(row[c]);\n    }\n    }\n"),
        ("    if (b16) half &= ~(1u << take_at);",
         "    if (b16) {\n      half &= ~(1u << take_at);\n"
         "      __syncwarp();\n    }")],
    # the current source on a plan whose segments follow row order alone
    # (the earlier layout: kernel B walks the visits in A's order)
    "rows_plan": [],
}


def variant_source(name: str, parent: str | None) -> str:
    if name == "parent":
        if parent is None:
            raise SystemExit("variant 'parent' needs --parent DIR")
        path = os.path.join(parent, os.path.relpath(SOURCE, REPO))
        with open(path) as f:
            return f.read()
    with open(SOURCE) as f:
        text = f.read()
    if name == "current":
        return text
    if name not in EDITS:
        raise SystemExit(f"unknown variant {name!r}: current, parent or one "
                         f"of {sorted(EDITS)}")
    for old, new in EDITS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build(name: str, text: str, out_dir: str) -> tuple[str, str]:
    """Compile one variant; returns (library path, ptxas output)."""
    src = os.path.join(out_dir, f"{name}.cu")
    lib = os.path.join(out_dir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name} does not build:\n{log[-4000:]}")
    return lib, log


def rank128_registers(log: str) -> dict[str, int]:
    """Registers of each step kernel's rank-128 instantiation, from
    ``-Xptxas -v`` (``<4>`` in the earlier source, ``<4, 1>`` now)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            kind = ("a" if "sgd_item_rows_kernel" in fn else
                    "b" if "sgd_user_rows_kernel" in fn else None)
            # <4>, <4, 1> in earlier sources; <4, 1, H> now (H: bf16)
            m = re.search(r"kernelILi4E(?:Li1E)?(?:Lb([01])E)?E", fn)
            name = (kind + ("_bf16" if m.group(1) == "1" else "")
                    if kind and m else None)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[f"{name}_registers"] = int(m.group(1))
            name = None
    return out


def main_problem(dev):
    """``chip_smoke.py``'s main-path data: tables, device arrays, the
    problem and its step plan."""
    cfg = DSGDConfig(**cs.BENCH)
    train, _ = synthetic_like("ml-25m", rank=16, noise=0.1, seed=0,
                              skew_lam=2.0)
    problem = blocking.block_problem(train, num_blocks=cs.K, seed=cfg.seed,
                                     minibatch_multiple=cfg.minibatch_size,
                                     minibatch_sort=cfg.minibatch_sort)
    icu, icv = blocking.minibatch_inv_counts(problem.ratings,
                                             cfg.minibatch_size)
    U0, V0 = DSGD(cfg)._init_factors(problem)
    args = cs.device_args(problem, icu, icv, dev)
    plan = cs.step_plan(args, cfg.minibatch_size)
    return cfg, problem, args, U0.to(dev), V0.to(dev), plan


def rows_plan(args, minibatch):
    """The step plan with a step's segments in row order alone."""
    order = cuda_sgd._visit_order
    cuda_sgd._visit_order = lambda visit, visits: (visit * 0, visit * 0)
    try:
        return cs.step_plan(args, minibatch)
    finally:
        cuda_sgd._visit_order = order


# one warp a row over `n` rows of `vecs` float4s: mode 0 reads each row
# (one float a warp kept), 1 writes each row, 2 reads it, adds 1 and
# writes it back in place
YARDSTICK_CU = r"""
#include <cuda_runtime.h>
__global__ void rows_kernel(float4* t, const int* rows, int n, int vecs,
                            int mode, float* sink) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;
  float4* r = t + (long long)rows[w] * vecs;
  float acc = 0.0f;
  for (int c = lane; c < vecs; c += 32) {
    if (mode == 1) {
      r[c] = make_float4(1.0f, 2.0f, 3.0f, 4.0f);
      continue;
    }
    float4 v = r[c];
    acc += v.x + v.y + v.z + v.w;
    if (mode == 2) r[c] = make_float4(v.x + 1, v.y + 1, v.z + 1, v.w + 1);
  }
  if (mode == 0 && lane == 0) sink[w] = acc;
}
extern "C" int rows_launch(void* t, const void* rows, int n, int vecs,
                           int mode, void* sink, void* stream) {
  rows_kernel<<<(n + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (float4*)t, (const int*)rows, n, vecs, mode, (float*)sink);
  return (int)cudaGetLastError();
}
"""


def yardstick(data, smi, lib):
    """Row traffic of step 0's distinct rows (module docstring); ``lib``
    is ``YARDSTICK_CU`` built."""
    _, _, _, U0, V0, plan = data
    e0, e1 = plan.entry_base[0], plan.entry_base[1]
    out = dict(yardstick="step 0's distinct rows, in walk order", card=smi)
    P = ctypes.c_void_p
    lib.rows_launch.restype = ctypes.c_int
    lib.rows_launch.argtypes = [P, P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, P, P]
    for side, table, prow in (("u", U0, plan.u_prow), ("v", V0, plan.v_prow)):
        pos = cuda_sgd.plan_rows(prow[e0:e1])
        first = torch.ones_like(pos, dtype=torch.bool)
        first[1:] = pos[1:] != pos[:-1]
        rows = pos[first]  # one per segment, in walk order
        T = table.clone()
        buf = torch.empty((rows.numel(), T.shape[1]), device=T.device)
        row_bytes = buf.numel() * 4
        rows32 = rows.int()
        sink = torch.empty(rows.numel(), device=T.device)
        stream = torch.cuda.current_stream().cuda_stream

        def own(mode):
            rc = lib.rows_launch(T.data_ptr(), rows32.data_ptr(),
                                 rows.numel(), T.shape[1] // 4, mode,
                                 sink.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"yardstick kernel: CUDA error {rc}")

        times = {
            "gather": (cs.cuda_ms(lambda: torch.index_select(
                T, 0, rows, out=buf), reps=20), 2 * row_bytes),
            "scatter": (cs.cuda_ms(lambda: T.index_copy_(0, rows, buf),
                                   reps=20), 2 * row_bytes),
            "read": (cs.cuda_ms(lambda: own(0), reps=20), row_bytes),
            "write": (cs.cuda_ms(lambda: own(1), reps=20), row_bytes),
            "rmw": (cs.cuda_ms(lambda: own(2), reps=20), 2 * row_bytes)}
        out[f"{side}_rows"] = rows.numel()
        for kind, (ms, nbytes) in times.items():
            out[f"{side}_{kind}_ms"] = ms
            out[f"{side}_{kind}_gbs"] = nbytes / ms / 1e6
    return out


def run_variant(name, lib, regs, data, smi):
    cfg, problem, args, U0, V0, plan = data
    if name == "rows_plan":
        plan = rows_plan(args, plan.minibatch)
    cuda_sgd._bound = cuda_sgd.declare(lib)
    ou, ov = args[4], args[5]
    lam = cfg.lambda_
    kw = dict(lr=schedule_from_name("warm_boost", lam)(0.3, 1), lam=lam)
    rank = U0.shape[-1]
    work = plan.new_work(rank)
    # stratum 0 against its plain version
    Uk, Vk = U0.clone(), V0.clone()
    cuda_sgd.stratum_sweep(Uk, Vk, ou, ov, plan, 0, work, **kw)
    idx, streams = cs.stratum_operands(args, problem, plan.minibatch)
    Ur, Vr = cuda_sgd.stratum_sweep_reference(
        U0, V0, idx, streams, 0, minibatch=plan.minibatch,
        num_blocks=cs.K, **kw)
    torch.cuda.synchronize()
    err = cs.max_abs([(Uk, Ur), (Vk, Vr)])
    del Ur, Vr
    digest = hashlib.sha256(Uk.cpu().numpy().tobytes()
                            + Vk.cpu().numpy().tobytes()).hexdigest()[:16]
    out = dict(variant=name, card=smi, max_abs=err, tables_sha256=digest,
               **regs)
    if hasattr(lib, "dsgd_step_kernel_attrs"):  # not in earlier sources
        out.update(cuda_sgd.step_kernel_attrs(rank))
    U, V = U0.clone(), V0.clone()
    out["a_ms"] = cs.cuda_ms(lambda: cuda_sgd.sgd_item_rows(
        U, V, ou, ov, plan, 0, work, **kw), reps=20)
    out["b_ms"] = cs.cuda_ms(lambda: cuda_sgd.sgd_user_rows(
        U, V, ou, ov, plan, 0, work, **kw), reps=20)
    U, V = U0.clone(), V0.clone()
    out["stratum_a_ms"], out["stratum_b_ms"] = cs.stratum_kernel_ms(
        U, V, ou, ov, plan, 0, work, kw)
    U, V = U0.clone(), V0.clone()
    out["cold_a_ms"], out["cold_b_ms"] = cs.cold_step_ms(
        U, V, ou, ov, plan, 0, work, kw)
    out["step_ms"] = out["a_ms"] + out["b_ms"]
    out["stratum_step_ms"] = out["stratum_a_ms"] + out["stratum_b_ms"]
    out["cold_step_ms"] = out["cold_a_ms"] + out["cold_b_ms"]
    if not (err <= cs.STRATUM_TOL or name.startswith("diag_")):
        raise AssertionError(f"variant {name}: stratum 0 max-abs {err:.3e}")
    return out


def bf16_routes(variant, data, smi, lib, sink):
    """The two bf16 routes on stratum 0 through ``variant``'s library
    (module docstring); prints and writes one JSON line a run."""
    cfg, problem, args, U0, V0, plan = data
    cuda_sgd._bound = cuda_sgd.declare(lib)
    ou, ov = args[4], args[5]
    lam = cfg.lambda_
    kw = dict(lr=schedule_from_name("warm_boost", lam)(0.3, 1), lam=lam)
    rank = U0.shape[-1]
    work = plan.new_work(rank)
    U16, V16 = U0.to(torch.bfloat16), V0.to(torch.bfloat16)
    Uw, Vw = torch.empty_like(U0), torch.empty_like(V0)
    routes = {
        "flagged": lambda U, V: cuda_sgd.stratum_sweep(
            Uw, Vw, ou, ov, plan, 0, work, store=(U, V), **kw),
        "cast": lambda U, V: cuda_sgd.stratum_sweep_cast(
            U, V, Uw, Vw, ou, ov, plan, 0, work, **kw)}
    outs = {}
    for name, route in routes.items():
        outs[name] = (U16.clone(), V16.clone())
        route(*outs[name])
    torch.cuda.synchronize()
    equal = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(outs["flagged"], outs["cast"]))
    if not equal:
        raise AssertionError("bf16 routes: flagged and cast tables differ")
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device=U0.device)

    def once(route, cold):
        U, V = U16.clone(), V16.clone()
        if cold:
            flush.fill_(1.0)
            flush.sum()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        route(U, V)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    bound = cs.stratum_bound_ms(plan, rank, 0, True)  # one function
    f32_bound = cs.stratum_bound_ms(plan, rank, 0, False)
    for name in ("cast", "flagged", "flagged", "cast"):
        route = routes[name]
        cuda_sgd.reset_launch_counts()
        warm = min(once(route, False) for _ in range(3))
        launches = {k: v // 3 for k, v in cuda_sgd.LAUNCHES.items()}
        cold = statistics.median(once(route, True) for _ in range(5))
        row = dict(route=f"bf16_{name}", variant=variant, card=smi, stratum=0,
                   bit_equal_to_other=equal, stratum_ms=warm,
                   cold_stratum_ms=cold, bound_ms=bound,
                   share_of_bound=bound / warm,
                   f32_stratum_bound_ms=f32_bound,
                   launches_per_stratum=launches)
        line = json.dumps(row)
        print(line, flush=True)
        sink.write(line + "\n")


def plan_build(data, smi, sink):
    """The plan's build and its touch flags alone (module docstring)."""
    _, _, args, _, _, plan = data
    su, si, sv, sw, _, _, icu, icv = args
    walls = {"plan_build_s": [], "touch_flags_s": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cuda_sgd.build_step_plan(su, si, sv, sw, icu, icv,
                                 minibatch=plan.minibatch)
        torch.cuda.synchronize()
        walls["plan_build_s"].append(time.perf_counter() - t0)
        _, step, u_rows, i_rows = cuda_sgd.plan_entries(su, si, sw,
                                                        plan.minibatch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rows, top in ((u_rows, plan.rows_u), (i_rows, plan.rows_v)):
            cuda_sgd.touch_flags(step, rows, plan.n_mb, plan.num_blocks, top)
        torch.cuda.synchronize()
        walls["touch_flags_s"].append(time.perf_counter() - t0)
    line = json.dumps(dict(plan="build_step_plan", card=smi,
                           **{k: min(v) for k, v in walls.items()},
                           flag_bytes=plan.v_flag.nbytes
                           + plan.u_flag.nbytes,
                           plan_bytes=plan.nbytes(),
                           entries=plan.entry_base[-1]))
    print(line, flush=True)
    sink.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--yardstick", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--out", default="step_pair.jsonl")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_pair_bench: no CUDA device", file=sys.stderr)
        return 2
    names = opts.variants.split(",")
    texts = {n: variant_source(n, opts.parent) for n in names}
    bf16_names = [n for n in names if n != "parent"]
    if opts.bf16 and not bf16_names:
        raise SystemExit("--bf16 needs a variant of the current source")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="step_pair_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        t0 = time.perf_counter()
        builds = {n: pool.submit(build, n, t, tmp) for n, t in texts.items()}
        if opts.yardstick:
            builds["yardstick"] = pool.submit(build, "yardstick",
                                              YARDSTICK_CU, tmp)
        data = main_problem(dev)
        libs = {n: f.result() for n, f in builds.items()}
        print(f"[setup] builds_and_data_s={time.perf_counter() - t0:.1f}",
              flush=True)
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "a") as sink:
            if opts.yardstick:
                line = json.dumps(yardstick(
                    data, smi, ctypes.CDLL(libs.pop("yardstick")[0])))
                print(line, flush=True)
                sink.write(line + "\n")
            for n in names + names[::-1]:
                path, log = libs[n]
                row = run_variant(n, ctypes.CDLL(path),
                                  rank128_registers(log), data, smi)
                line = json.dumps(row)
                print(line, flush=True)
                sink.write(line + "\n")
            if opts.bf16:
                for n in bf16_names + bf16_names[::-1]:
                    bf16_routes(n, data, smi, ctypes.CDLL(libs[n][0]), sink)
                plan_build(data, smi, sink)
    return 0


if __name__ == "__main__":
    sys.exit(main())
