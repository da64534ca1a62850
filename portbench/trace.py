"""The traced tail of a ``--trace 1`` run: ``torch.profiler`` over the
card, framed by edge kernels, reduced to what the per-layer readers and
the result line need.

A capture loses its first device records unless the window is framed: the
profiler opens, a quarter second passes, ``EDGE_LAUNCHES`` launches of a
kernel the program never runs (``exp2``) are made, then the work, then as
many edge launches again. The edges found are reported on a line of their
own, before the result (``edges``: expected, found, lost). The traced
window runs on the device from the end of the last leading edge to the
start of the first trailing one; with leading edges lost it starts at the
first device record.

``busy_s`` is the union of the device records (kernels, copies, sets) in
the window; ``idle_gaps`` sums the ``LABELLED_GAPS`` longest gaps between
them by what the host was doing at each gap's middle: the innermost host
record open then (an operator, a runtime call, or a harness span
``torch.profiler.record_function("bench/…")``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

EDGE_LAUNCHES = 64
EDGE_MARK = "exp2"
MARGIN_S = 0.25
LABELLED_GAPS = 200


@dataclasses.dataclass
class Profile:
    busy_s: float
    window_s: float
    kernels: dict  # kernel name → seconds summed over the window
    edges: dict
    breakdown: dict


def _ns(ev, what: str) -> float:
    """An event's start or duration in ns, across profiler versions."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def _is_device(ev) -> bool:
    dt = str(ev.device_type())
    return "CUDA" in dt.upper()


def capture(ctx, work) -> Profile:
    import torch
    from torch.profiler import ProfilerActivity, profile

    edge = torch.zeros(256, device=ctx.device)
    edge_out = torch.empty_like(edge)

    def edges():
        for _ in range(EDGE_LAUNCHES):
            torch.exp2(edge, out=edge_out)

    ctx.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        edges()
        ctx.sync()
        work()
        ctx.sync()
        edges()
        ctx.sync()
    raw = prof.profiler.kineto_results.events()
    device, host = [], []
    for ev in raw:
        start = _ns(ev, "start") * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        name = ev.name()
        if _is_device(ev):
            # the profiler mirrors a harness span on the device's
            # timeline too, where it is no device work
            if not name.startswith("bench/"):
                device.append((name, start, end))
        else:
            host.append((name, start, end))
    device.sort(key=lambda r: r[1])
    edge_recs = [r for r in device if EDGE_MARK in r[0]]
    work_recs = [r for r in device if EDGE_MARK not in r[0]]
    found = len(edge_recs)
    lead = [r for r in edge_recs
            if not work_recs or r[2] <= work_recs[0][1]]
    trail = [r for r in edge_recs if work_recs and r[1] >= work_recs[-1][2]]
    if work_recs:
        w0 = lead[-1][2] if lead else work_recs[0][1]
        w1 = trail[0][1] if trail else work_recs[-1][2]
    else:
        w0 = w1 = 0.0
    window = [r for r in work_recs if r[1] >= w0 and r[2] <= w1]
    kernels: dict = {}
    for name, a, b in window:
        kernels[name] = kernels.get(name, 0.0) + (b - a)
    busy, gaps = 0.0, []
    cur_a, cur_b = None, None
    for _, a, b in window:
        if cur_b is None:
            if a > w0:
                gaps.append((w0, a))
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        if w1 > cur_b:
            gaps.append((cur_b, w1))
    by_host: dict = {}
    h_start = np.array([h[1] for h in host])
    h_end = np.array([h[2] for h in host])
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        open_ = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        label = (host[open_[np.argmin((h_end - h_start)[open_])]][0]
                 if open_.size else "no host record")
        by_host[label] = by_host.get(label, 0.0) + (b - a)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return Profile(
        busy_s=busy, window_s=max(w1 - w0, 0.0), kernels=kernels,
        edges={"edge_expected": 2 * EDGE_LAUNCHES, "edge_found": found,
               "edge_lost": 2 * EDGE_LAUNCHES - found,
               "leading_found": len(lead), "trailing_found": len(trail),
               "device_records": len(window)},
        breakdown={"device_ops": [[n, s] for n, s in top_ops],
                   "idle_gaps": [[n, s] for n, s in top_gaps]})


def kernel_seconds(profile: Profile, *names: str) -> float:
    """Seconds of the window's device records whose name holds any of
    ``names``."""
    return sum(s for k, s in profile.kernels.items()
               if any(n in k for n in names))


def idle_share(profile: Profile) -> float | None:
    if profile is None or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
