"""Thread-safe metrics registry: labeled counters, gauges, histograms
(counterpart of ``large_scale_recommendation_tpu.obs.registry``; no
framework code, so the same instruments, bucket geometry and exporters:
the same calls give the same snapshot and Prometheus text).

One registry per process is the intended shape (the module-level default
installed by ``obs.enable()``); components hold instrument handles, not
the registry, so the lookup cost is paid once at construction and the
hot path is a single locked add.

Histograms are **log-bucketed**: bucket boundaries are powers of
``2**(1/4)`` (≈ +19% per bucket), so a histogram spanning nanoseconds to
kiloseconds costs ~250 sparse dict slots and quantile estimates carry a
bounded ~9% relative error (half a bucket, geometric midpoint) —
validated against a numpy reference in the JAX package's tests.
Exact count/sum/min/max ride alongside, so means and totals are exact.

Exporters:

- ``snapshot()`` — one plain dict (JSON-safe) of every instrument.
- ``append_jsonl(path)`` — snapshot as one JSON line (append mode):
  the time-series form a dashboard tails.
- ``to_prometheus()`` — Prometheus text exposition (counters/gauges as
  samples, histograms as quantile-labeled summaries).

The ``NullRegistry`` twin is the zero-cost disabled form: its
``counter``/``gauge``/``histogram`` return shared stateless singletons
whose mutators are no-ops — no locks, no allocations, nothing to export.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Iterable

# bucket geometry: value v lands in bucket floor(log_base(v/_HIST_MIN));
# base 2**0.25 keeps quantile error under ~9% (geometric midpoint read)
_HIST_BASE = 2.0 ** 0.25
_HIST_LOG = math.log(_HIST_BASE)
_HIST_MIN = 1e-9  # values at or below this share bucket 0


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline). A label value carrying quotes is real: the health gauge's
    ``check`` label holds check NAMES, and ``watch_series`` defaults
    those to recorder series keys like ``lag{partition="0"}`` — emitted
    unescaped, one such check would abort the whole /metrics parse."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in key) + "}"


class Counter:
    """Monotonic counter. ``inc(n)`` under the instrument's own lock."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Log-bucketed distribution with p50/p90/p99 quantile estimates.

    Buckets are sparse (dict index → count): observing a value costs one
    log, one dict add, and the instrument lock. ``quantile(q)`` walks the
    cumulative counts and returns the geometric midpoint of the crossing
    bucket — within half a bucket (~9%) of the true order statistic.
    """

    __slots__ = ("name", "labels", "count", "sum", "min", "max",
                 "_buckets", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict[int, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def bucket_index(v: float) -> int:
        if v <= _HIST_MIN:
            return 0
        return 1 + int(math.log(v / _HIST_MIN) / _HIST_LOG)

    @staticmethod
    def bucket_bounds(idx: int) -> tuple[float, float]:
        """[lo, hi) value bounds of bucket ``idx`` (bucket 0 is
        (-inf, _HIST_MIN])."""
        if idx == 0:
            return 0.0, _HIST_MIN
        return (_HIST_MIN * _HIST_BASE ** (idx - 1),
                _HIST_MIN * _HIST_BASE ** idx)

    def observe(self, v: float) -> None:
        v = float(v)
        idx = self.bucket_index(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        with self._lock:
            if self.count == 0:
                return float("nan")
            target = q * self.count
            seen = 0
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if seen >= target:
                    lo, hi = self.bucket_bounds(idx)
                    # clamp to the observed extremes: exact min/max beat
                    # the bucket bound at the distribution's edges
                    mid = math.sqrt(max(lo, _HIST_MIN * 1e-3) * hi)
                    return min(max(mid, self.min), self.max)
            return self.max  # unreachable, counts always cross

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean if self.count else None,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.quantile(0.50) if self.count else None,
            "p90": self.quantile(0.90) if self.count else None,
            "p99": self.quantile(0.99) if self.count else None,
        }


class MetricsRegistry:
    """Process-wide instrument registry.

    ``counter(name, **labels)`` / ``gauge`` / ``histogram`` create on
    first use and return the same instrument for the same
    (name, labels) after — handles are meant to be cached by the caller
    (instrumented components bind them at construction)."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    def _get(self, store: dict, cls, name: str, labels: dict):
        key = (name, _labels_key(labels))
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.get(key)
                if inst is None:
                    inst = store[key] = cls(name, key[1])
        return inst

    def counter(self, name: str, /, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, /, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    # -- introspection ------------------------------------------------------

    def names(self) -> set[str]:
        with self._lock:
            return ({n for n, _ in self._counters}
                    | {n for n, _ in self._gauges}
                    | {n for n, _ in self._histograms})

    def find(self, name: str) -> list:
        """Every instrument (any type / label set) registered as ``name``."""
        with self._lock:
            stores: Iterable[dict] = (self._counters, self._gauges,
                                      self._histograms)
            return [inst for store in stores
                    for (n, _), inst in store.items() if n == name]

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-safe dict of every instrument's current state."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
        metrics = []
        for c in counters:
            metrics.append({"name": c.name, "type": "counter",
                            "labels": dict(c.labels), "value": c.value})
        for g in gauges:
            metrics.append({"name": g.name, "type": "gauge",
                            "labels": dict(g.labels), "value": g.value})
        for h in histograms:
            metrics.append({"name": h.name, "type": "histogram",
                            "labels": dict(h.labels), **h.summary()})
        metrics.sort(key=lambda m: (m["name"], sorted(m["labels"].items())))
        return {"time": time.time(), "metrics": metrics}

    def append_jsonl(self, path: str) -> dict:
        """Append one snapshot line to ``path``; returns the snapshot."""
        snap = self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")
        return snap

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4). Histograms export
        as summaries: ``name{quantile="0.5"}``, ``name_sum``,
        ``name_count``."""
        lines: list[str] = []
        snap = self.snapshot()
        seen_types: set[str] = set()
        for m in snap["metrics"]:
            name, labels = m["name"], _labels_str(_labels_key(m["labels"]))
            if m["type"] in ("counter", "gauge"):
                if name not in seen_types:
                    seen_types.add(name)
                    lines.append(f"# TYPE {name} {m['type']}")
                lines.append(f"{name}{labels} {m['value']:g}")
            else:
                if name not in seen_types:
                    seen_types.add(name)
                    lines.append(f"# TYPE {name} summary")
                base = _labels_key(m["labels"])
                for q, val in (("0.5", m["p50"]), ("0.9", m["p90"]),
                               ("0.99", m["p99"])):
                    if val is None:
                        continue
                    qlabels = _labels_str(base + (("quantile", q),))
                    lines.append(f"{name}{qlabels} {val:g}")
                lines.append(f"{name}_sum{labels} {m['sum']:g}")
                lines.append(f"{name}_count{labels} {m['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------------
# Null layer: the zero-cost disabled form
# --------------------------------------------------------------------------


class _NullInstrument:
    """Shared stateless no-op instrument: every null counter/gauge/
    histogram is THIS one object, so the disabled path allocates nothing
    and takes no locks."""

    __slots__ = ()
    name = ""
    labels = ()
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, n: float = 1.0) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return float("nan")

    def summary(self) -> dict:
        return {}


NULL_INSTRUMENT = _NullInstrument()


class NullRegistry(MetricsRegistry):
    """Disabled registry: hands out the shared null instrument, records
    nothing, exports nothing. ``enabled = False`` is the one-bool fast
    path instrumented hot loops cache at construction."""

    enabled = False

    def __init__(self):  # no stores, no lock
        pass

    def counter(self, name: str, /, **labels):
        return NULL_INSTRUMENT

    def gauge(self, name: str, /, **labels):
        return NULL_INSTRUMENT

    def histogram(self, name: str, /, **labels):
        return NULL_INSTRUMENT

    def names(self) -> set[str]:
        return set()

    def find(self, name: str) -> list:
        return []

    def snapshot(self) -> dict:
        return {"time": time.time(), "metrics": []}

    def append_jsonl(self, path: str) -> dict:
        return self.snapshot()

    def to_prometheus(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()
_REGISTRY: MetricsRegistry = NULL_REGISTRY


def get_registry() -> MetricsRegistry:
    """The module-level default registry (the null one unless
    ``obs.enable()`` installed a live registry)."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> None:
    global _REGISTRY
    _REGISTRY = registry
