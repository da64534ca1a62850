#!/usr/bin/env python3
"""Count the device records a ``torch.profiler`` capture of the PyTorch
port's DSGD sweep loses, and where, on one NVIDIA GPU.

    python3 scripts/torch_profile_edges.py [--captures 12]
        [--margins 0,0.02,0.25] [--out profile_edges.jsonl]

The sweep is ``chip_smoke.py``'s ``[obs.train]`` profiled one: the
ML-25M-shaped device problem of ``[main.device]`` (k 8, rank 128,
minibatch 32,768), one ``dsgd_train_cuda`` sweep given its step plan (2
clone copies, then 96 launches of each step kernel), with observability
on as there (registry, tracer, journal, introspection at 0.25 s, the
transfer guard in ``log`` mode). Each capture goes through the port's
``profile_trace``: the window opens, ``margin`` seconds pass, the sweep
runs, ``margin`` seconds pass, the window closes. With ``framed`` the
window also holds ``chip_smoke.PROFILE_EDGE_LAUNCHES`` small kernels
before and after, as ``[obs.train]`` now has it. The margins and both
forms alternate, ``--captures`` of each.

Each capture prints one JSON line (and appends it to ``--out``): the
sweep's device records found of those expected, the positions of the
device records missing, in the capture's launch order (its
``cudaLaunchKernel`` / ``cudaMemcpyAsync`` records, the leading edge
launches first when framed; empty when those are lost too), the edge
records found, the profiler's start wall, and ``offset_ms``: the trace's
first sweep device record less the host clock read just before the
sweep (the copy starts some 0.2 ms after it; a value far from that
says the trace's CUDA clock is off the host's). The last line sums it
up, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from large_scale_recommendation_tpu_torch import obs  # noqa: E402
from large_scale_recommendation_tpu_torch.obs.introspect import (  # noqa: E402
    TRACE_FILE,
    profile_trace,
)

SWEEP = ("sgd_item_rows_kernel", "sgd_user_rows_kernel", "Memcpy DtoD")
LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync")


def read_capture(path: str, t_sweep_us: float) -> dict:
    """What one capture's trace holds of the sweep and of its edges."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    device = sorted((e for e in events if e.get("ph") == "X" and e.get(
        "cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
        key=lambda e: e["ts"])
    sweep = [e for e in device if any(n in e["name"] for n in SWEEP)]
    seen = {e["args"].get("correlation") for e in device}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and e.get("name") in LAUNCH), key=lambda e: e["ts"])
    return dict(
        sweep_found=len(sweep), edge_found=len(device) - len(sweep),
        missing_at=[k for k, e in enumerate(launches)
                    if e["args"].get("correlation") not in seen],
        offset_ms=((sweep[0]["ts"] + base_us - t_sweep_us) / 1e3
                   if sweep else None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--captures", type=int, default=12)
    ap.add_argument("--margins", default="0,0.02,0.25")
    ap.add_argument("--out", default="profile_edges.jsonl")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_edges: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="profile_edges_") as scratch:
        return run(opts, smi, scratch)


def run(opts, smi: str, scratch: str) -> int:
    """Every capture; traces go under ``scratch``."""
    cs.build_all()
    cfg = cs.DSGDConfig(**cs.BENCH)
    _, _, data = cs.phase_device(torch.device("cuda"), cfg, scratch)
    u, i, r = data["train"]
    args = data["args"]
    reg, tracer = obs.enable()
    obs.set_events(obs.EventJournal())
    tracer.install_build_hook(reg)
    intro = obs.enable_introspection(interval_s=0.25)
    obs.enable_transfers(guard="log")
    solver = cs.DSGD(cfg)
    model = solver.fit_device(u, i, r, data["nu"], data["ni"],
                              num_blocks=cs.K, checkpoint_every=1)
    sched = cs.schedule_from_name(cfg.lr_schedule, cfg.lambda_)
    edge = torch.zeros(1024, device=model.U.device)
    n_mb = args[0].shape[-1] // cfg.minibatch_size

    def sweep():
        cs.cuda_sgd.dsgd_train_cuda(
            model.U, model.V, *args, lr=cfg.learning_rate, lam=cfg.lambda_,
            minibatch=cfg.minibatch_size, num_blocks=cs.K, iterations=1,
            schedule=sched, t0=cfg.iterations, plan=solver._plan)
        torch.cuda.synchronize()

    def edge_records():
        for _ in range(cs.PROFILE_EDGE_LAUNCHES):
            edge.add_(1.0)
        torch.cuda.synchronize()

    sweep()
    margins = [float(m) for m in opts.margins.split(",")]
    rows = []
    with open(opts.out, "a") as out:
        for n in range(opts.captures):
            for margin in margins:
                for framed in (False, True):
                    trace_dir = os.path.join(scratch, f"c{len(rows)}")
                    t_a = time.perf_counter()
                    with profile_trace(trace_dir):
                        start_s = time.perf_counter() - t_a
                        if framed:
                            edge_records()
                        time.sleep(margin)
                        t_sweep = time.time() * 1e6
                        sweep()
                        time.sleep(margin)
                        if framed:
                            edge_records()
                    row = dict(capture=len(rows), margin=margin,
                               framed=framed, sweep_expected=2 + 2 * n_mb
                               * cs.K, profiler_start_ms=start_s * 1e3,
                               **read_capture(os.path.join(
                                   trace_dir, TRACE_FILE), t_sweep))
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    out.write(json.dumps(row) + "\n")
    intro.stop()
    lossy = [r for r in rows if r["sweep_found"] != r["sweep_expected"]]
    offsets = [r["offset_ms"] for r in rows if r["offset_ms"] is not None]
    print(json.dumps(dict(
        card=smi, captures=len(rows), lossy=len(lossy),
        lossy_captures=[r["capture"] for r in lossy],
        edge_expected=2 * cs.PROFILE_EDGE_LAUNCHES,
        edge_found_min=min((r["edge_found"] for r in rows if r["framed"]),
                           default=None),
        offset_ms_min=min(offsets, default=None),
        offset_ms_max=max(offsets, default=None))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
