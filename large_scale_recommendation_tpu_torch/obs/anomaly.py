"""Anomaly detection over flight-recorder series: EWMA z-score + rate of
change (counterpart of ``large_scale_recommendation_tpu.obs.anomaly``;
numpy only, the same arithmetic, so both packages give the same verdicts
on the same series).

Static health thresholds need someone to KNOW the right number — but the
right number for throughput or lag depends on workload, card and time of
day. These detectors learn the recent normal from the recorder's own
history and flag departures from it, with no threshold configured.

- ``ewma_mean_var(values, alpha)`` — exponentially weighted mean and
  variance (``d = x - m; m += α·d; v = (1-α)·(v + α·d²)``), per step.
- ``ewma_zscore(values, alpha)`` — the z-score of the LAST value against
  the EWMA mean/stddev of everything BEFORE it.
- ``rate_of_change(values, span)`` — relative change of the last value vs
  ``span`` steps earlier: ``(last - prev) / max(|prev|, eps)``.

``AnomalyCheck`` packages them as a ``HealthMonitor`` check over one
recorder series: OK while warming, DEGRADED at ``degraded_z`` deviations,
CRITICAL at ``critical_z`` — with a ``direction`` filter so a throughput
check pages on collapses, not on the system getting faster.
``mode="delta"`` first-differences the series (a counter → its rate).

``MonotonicGrowthCheck`` is the detector for what EWMA cannot see: a slow
LEAK never departs from its own recent baseline — the unbroken monotonic
run is what matters. It watches the ``device_bytes_in_use{device=}``
series ``obs.introspect`` publishes (on the card: one per CUDA device,
``device="cuda:0"``; worst verdict wins; no series — the CPU has no
allocator stats — is OK).
"""

from __future__ import annotations

import math

import numpy as np

from large_scale_recommendation_tpu_torch.obs.health import (
    CheckResult,
    critical,
    degraded,
    ok,
)

DIRECTIONS = ("drop", "spike", "both")


def ewma_mean_var(values, alpha: float = 0.25):
    """Per-step EWMA mean and variance arrays (same length as input)."""
    v = np.asarray(values, dtype=np.float64)
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    means = np.empty_like(v)
    variances = np.empty_like(v)
    m = var = 0.0
    for i, x in enumerate(v):
        if i == 0:
            m, var = float(x), 0.0
        else:
            d = float(x) - m
            m += alpha * d
            var = (1.0 - alpha) * (var + alpha * d * d)
        means[i] = m
        variances[i] = var
    return means, variances


def ewma_zscore(values, alpha: float = 0.25) -> float:
    """z of ``values[-1]`` against the EWMA baseline of ``values[:-1]``.

    A near-zero learned variance (flat series) is floored relative to
    the mean's magnitude, so a genuine step off a perfectly flat
    baseline reads as a large-but-finite z instead of dividing by
    zero."""
    v = np.asarray(values, dtype=np.float64)
    if len(v) < 2:
        return 0.0
    means, variances = ewma_mean_var(v[:-1], alpha)
    m = float(means[-1])
    std = math.sqrt(float(variances[-1]))
    floor = 1e-9 + 1e-3 * abs(m)
    return (float(v[-1]) - m) / max(std, floor)


def rate_of_change(values, span: int = 1) -> float:
    """Relative change of the last value vs ``span`` steps earlier."""
    v = np.asarray(values, dtype=np.float64)
    if span < 1:
        raise ValueError(f"span must be >= 1, got {span}")
    if len(v) <= span:
        return 0.0
    prev, last = float(v[-1 - span]), float(v[-1])
    return (last - prev) / max(abs(prev), 1e-9)


class AnomalyCheck:
    """Threshold-free health check over one flight-recorder series.

    ``recorder`` is an ``obs.recorder.FlightRecorder``; ``series`` a
    key from ``recorder.series_names()`` (``series_key(name, labels)``
    builds one). ``direction``: ``"drop"`` pages only on values below
    the learned baseline (throughput), ``"spike"`` only above (lag,
    latency), ``"both"`` on either. ``mode="delta"`` first-differences
    the series (counters → rates). The verdict carries the z-score,
    the rate of change, the baseline, and the last value, so a
    ``/healthz`` reader sees WHY it flagged.
    """

    def __init__(self, recorder, series: str, alpha: float = 0.25,
                 warmup: int = 8, degraded_z: float = 3.0,
                 critical_z: float = 6.0, direction: str = "both",
                 mode: str = "value", max_points: int = 256,
                 roc_span: int = 1):
        if direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {direction!r}; expected "
                             f"one of {DIRECTIONS}")
        if mode not in ("value", "delta"):
            raise ValueError(f"unknown mode {mode!r}; expected 'value' or "
                             "'delta'")
        if warmup < 3:
            raise ValueError(f"warmup must be >= 3, got {warmup}")
        if not 0 < degraded_z <= critical_z:
            raise ValueError(f"need 0 < degraded_z <= critical_z, got "
                             f"({degraded_z}, {critical_z})")
        self.recorder = recorder
        self.series = series
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.degraded_z = float(degraded_z)
        self.critical_z = float(critical_z)
        self.direction = direction
        self.mode = mode
        self.max_points = int(max_points)
        self.roc_span = int(roc_span)

    def _signal(self, values) -> tuple[float, float]:
        vals = np.asarray(values, dtype=np.float64)
        if self.mode == "delta":
            vals = np.diff(vals)
        if len(vals) < 2:
            return 0.0, 0.0
        return (ewma_zscore(vals, self.alpha),
                rate_of_change(vals, self.roc_span))

    def _effective(self, z: float) -> float:
        """The severity-relevant magnitude after the direction filter:
        a drop-watcher ignores positive z entirely (and vice versa)."""
        if self.direction == "drop":
            return max(0.0, -z)
        if self.direction == "spike":
            return max(0.0, z)
        return abs(z)

    def __call__(self) -> CheckResult:
        values = self.recorder.series_values(self.series,
                                             last_n=self.max_points)
        # A non-finite LAST value IS the incident (a NaN gauge is
        # exactly what precedes a trip), and any non-finite sample left
        # in the window would propagate through the EWMA baseline:
        # z=NaN compares False against every threshold, so the check
        # would return ok through a genuine collapse — and the bare NaN
        # in the detail would break strict-JSON /healthz readers.
        if values and not math.isfinite(values[-1]):
            return critical(series=self.series, reason="non_finite_value",
                            last=repr(values[-1]), points=len(values))
        finite = [x for x in values if math.isfinite(x)]
        dropped = len(values) - len(finite)
        need = self.warmup + (1 if self.mode == "delta" else 0)
        if len(finite) < need:
            return ok(note=f"warming ({len(finite)}/{need} points)",
                      series=self.series)
        z, roc = self._signal(finite)
        eff = self._effective(z)
        detail = {
            "series": self.series,
            "z": round(z, 3),
            "rate_of_change": round(roc, 4),
            "last": finite[-1],
            "points": len(finite),
            "direction": self.direction,
            "mode": self.mode,
        }
        if dropped:
            detail["non_finite_dropped"] = dropped
        if eff >= self.critical_z:
            return critical(**detail)
        if eff >= self.degraded_z:
            return degraded(**detail)
        return ok(**detail)


class MonotonicGrowthCheck:
    """Leak detector over device-memory series: flags sustained
    MONOTONIC growth, the signature an EWMA z-score is structurally
    blind to (a slow leak never departs from its own recent baseline —
    each step is small; it's the run that kills the process).

    Watches every recorder series whose key starts with
    ``series_prefix`` (default ``device_bytes_in_use`` — one series per
    local device, published by
    ``obs.introspect.Introspector.sample_device_memory``), worst
    verdict wins across devices. Per series: the trailing run of
    non-decreasing samples with at least one strict increase must reach
    ``min_run`` points to count as growth; growth over the run relative
    to its start ≥ ``degraded_growth_frac`` → DEGRADED, ≥
    ``critical_growth_frac`` → CRITICAL. No matching series (CPU — no
    allocator stats surface, so the sampler publishes nothing) is OK
    with a note: absent telemetry is the documented graceful path, not
    an incident."""

    def __init__(self, recorder, series_prefix: str = "device_bytes_in_use",
                 min_run: int = 8, degraded_growth_frac: float = 0.05,
                 critical_growth_frac: float = 0.5, max_points: int = 256):
        if min_run < 2:
            raise ValueError(f"min_run must be >= 2, got {min_run}")
        if not 0 < degraded_growth_frac <= critical_growth_frac:
            raise ValueError(
                f"need 0 < degraded_growth_frac <= critical_growth_frac, "
                f"got ({degraded_growth_frac}, {critical_growth_frac})")
        self.recorder = recorder
        self.series_prefix = series_prefix
        self.min_run = int(min_run)
        self.degraded_growth_frac = float(degraded_growth_frac)
        self.critical_growth_frac = float(critical_growth_frac)
        self.max_points = int(max_points)

    def _verdict_for(self, key: str) -> CheckResult:
        values = [v for v in self.recorder.series_values(
            key, last_n=self.max_points) if math.isfinite(v)]
        if len(values) < self.min_run:
            return ok(series=key,
                      note=f"warming ({len(values)}/{self.min_run} points)")
        # trailing run of non-decreasing samples
        run_start = len(values) - 1
        while run_start > 0 and values[run_start - 1] <= values[run_start]:
            run_start -= 1
        run = values[run_start:]
        base = run[0]
        # "still leaking NOW": the latest STRICT increase must be
        # recent (within the trailing min_run samples). Without this, a
        # normal startup allocation ramp followed by a stable plateau
        # keeps flagging until the ramp ages out of the whole window —
        # flat samples extend the run, and the near-zero pre-ramp base
        # makes growth_frac astronomical. A plateau of min_run flat
        # samples clears the verdict instead.
        tail = run[-self.min_run:]
        still_growing = any(b > a for a, b in zip(tail, tail[1:]))
        growing = (len(run) >= self.min_run and run[-1] > base
                   and still_growing)
        growth_frac = ((run[-1] - base) / max(abs(base), 1e-9)
                       if growing else 0.0)
        detail = {"series": key, "run_points": len(run),
                  "growth_frac": round(growth_frac, 4),
                  "last": run[-1], "run_start_value": base}
        if growing and growth_frac >= self.critical_growth_frac:
            return critical(**detail)
        if growing and growth_frac >= self.degraded_growth_frac:
            return degraded(**detail)
        return ok(**detail)

    def __call__(self) -> CheckResult:
        keys = [k for k in self.recorder.series_names()
                if k.startswith(self.series_prefix)]
        if not keys:
            return ok(note="no matching series (device memory stats "
                           "absent on this backend)",
                      prefix=self.series_prefix)
        worst: CheckResult | None = None
        from large_scale_recommendation_tpu_torch.obs.health import SEVERITY

        for key in keys:
            res = self._verdict_for(key)
            if worst is None or SEVERITY[res.status] > SEVERITY[worst.status]:
                worst = res
        return worst
