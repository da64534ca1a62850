"""FlightRecorder: always-on metric history + postmortem bundles
(counterpart of ``large_scale_recommendation_tpu.obs.recorder``).

The registry serves the current instant and the health layer evaluates
thresholds against it — so when a watchdog trips or an SLO burns, the
lead-up is already gone. This module is the black box: a fixed-memory
time-series store that samples every registry instrument on a timed
cadence, plus the incident artifact writer that freezes the recent series,
the event tail, the span tail, and the health/registry snapshots into one
atomic bundle directory the moment something breaks.

- ``SeriesRing`` — one series' storage: a dense recent window (every
  sample) and a decimated old window (every ``decimation``-th point
  evicted from the recent tier), both hard-capped, so a series costs at
  most ``recent_points + decimated_points`` (t, v) pairs forever.
- ``FlightRecorder`` — walks ``registry.snapshot()`` per ``sample()``:
  counters/gauges record their value, histograms record ``count`` and
  quantile fields (``:p50``/``:p99`` key suffixes). ``start()`` runs the
  sampler on ``obs.health.PeriodicTask`` (``ensure_periodic``). The
  series table is capped (``max_series``; overflow counted, never grown).
  ``obs.server.ObsServer`` serves ``snapshot()`` at ``/seriesz``;
  ``obs.anomaly.AnomalyCheck`` reads ``series_values()``.
- ``write_bundle`` / ``FlightRecorder.dump`` — the postmortem artifact: a
  directory written atomically (a temp directory, then one
  ``os.replace``) holding the JAX package's ``BUNDLE_FILES`` and a
  ``manifest.json`` indexing them, at the same ``BUNDLE_VERSION``, so a
  bundle either package writes validates under the other's
  ``validate_bundle``. Triggers: watchdog trip, a CRITICAL health
  transition (``HealthMonitor``), or an explicit ``dump()``.

Differences from the JAX package, by design:

- ``config.json`` freezes the card's runtime knobs: the environment
  variables under ``CUDA_``, ``TORCH_``, ``PYTORCH_``, ``NCCL_``, ``OBS_``
  and ``BENCH_`` (the JAX package's ``JAX_`` / ``XLA_`` / ``TPU_`` /
  ``LIBTPU`` name nothing the port reads).
- ``device_memory.json`` is a fresh ``Introspector.sample_device_memory
  (publish=False)``. Its live-tensor walk (``gc.get_objects()``, under the
  switch-interval guard of ``obs.introspect``) runs only when the bundle
  is written on the main thread: a bundle frozen from another thread
  (``HealthMonitor`` on a scrape or a periodic thread) skips the walk and
  says so (``live_arrays: null`` and ``live_arrays_note``).
- ``profile_on_trip_s`` captures through ``obs.introspect.capture_profile``
  (``torch.profiler``, one capture per process); a profiler already
  recording leaves ``profile/note.json`` in the bundle instead.
- A sample reads Python floats only: the registry converts every value
  as it takes it (``obs.registry``), so sampling never waits on the card.

Zero-cost when unused: the module default is ``None`` (``get_recorder``)
and nothing on a training or serving hot path touches a recorder —
sampling happens on the recorder's own thread, against the registry the
hot paths were already writing.
"""

from __future__ import annotations

import json
import math
import os
import platform
import shutil
import sys
import tempfile
import threading
import time
from collections import deque

from large_scale_recommendation_tpu_torch.obs.events import (
    _json_safe,
    get_events,
)
from large_scale_recommendation_tpu_torch.obs.registry import (
    _labels_key,
    _labels_str,
    get_registry,
)
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer

# the JAX package's bundle schema, version for version: version 2 added
# device_memory.json, 3 lineage.json, 4 contention.json, 5 store.json,
# 6 transfers.json, 7 budget.json, 8 requests.json. An archived bundle of
# any version stays loadable: the loader validates per the version it finds
BUNDLE_VERSION = 8
BUNDLE_FILES = ("series.json", "events.jsonl", "trace.json", "health.json",
                "metrics.json", "config.json", "device_memory.json",
                "lineage.json", "contention.json", "store.json",
                "transfers.json", "budget.json", "requests.json")
_BUNDLE_FILES_BY_VERSION = {v: BUNDLE_FILES[:len(BUNDLE_FILES) - 8 + v]
                            for v in range(1, BUNDLE_VERSION + 1)}
# env prefixes worth freezing into a bundle — runtime knobs, never secrets
_ENV_PREFIXES = ("CUDA_", "TORCH_", "PYTORCH_", "NCCL_", "OBS_", "BENCH_")


class SeriesRing:
    """Two-tier bounded history for one series.

    Dense tier: the newest ``recent_points`` samples, every one kept. Old
    tier: of the samples evicted from the dense tier, every
    ``decimation``-th survives, newest ``decimated_points`` of those.
    Memory is capped at ``recent_points + decimated_points`` points."""

    __slots__ = ("recent_points", "decimation", "_recent", "_old",
                 "_evicted")

    def __init__(self, recent_points: int = 512,
                 decimated_points: int = 512, decimation: int = 8):
        if recent_points < 1 or decimated_points < 0 or decimation < 1:
            raise ValueError(
                f"bad ring geometry ({recent_points}, {decimated_points}, "
                f"{decimation})")
        self.recent_points = int(recent_points)
        self.decimation = int(decimation)
        self._recent: deque[tuple[float, float]] = deque()
        # maxlen=0 is valid and means "no old tier" (decimated_points=0)
        self._old: deque[tuple[float, float]] = deque(
            maxlen=int(decimated_points))
        self._evicted = 0

    def append(self, t: float, v: float) -> None:
        if len(self._recent) >= self.recent_points:
            point = self._recent.popleft()
            # keep the FIRST of each decimation stride: the old tier is a
            # uniform every-Nth subsample of the evicted stream
            if self._evicted % self.decimation == 0:
                self._old.append(point)
            self._evicted += 1
        self._recent.append((float(t), float(v)))

    def points(self) -> list[tuple[float, float]]:
        """Old (decimated) then recent (dense), oldest→newest."""
        return list(self._old) + list(self._recent)

    def values(self, last_n: int | None = None) -> list[float]:
        pts = self.points()
        if last_n is not None and len(pts) > last_n:
            pts = pts[-last_n:]
        return [v for _, v in pts]

    def __len__(self) -> int:
        return len(self._old) + len(self._recent)


def series_key(name: str, labels: dict, field: str | None = None) -> str:
    """Canonical series name: ``name{label="v"}`` (+ ``:field`` for
    histogram-derived series) — the Prometheus label text, so keys read
    the same in ``/metrics`` and ``/seriesz``."""
    key = f"{name}{_labels_str(_labels_key(labels))}"
    return f"{key}:{field}" if field else key


class FlightRecorder:
    """Samples the whole registry into bounded per-series rings.

    ``interval_s`` is the cadence ``start()`` runs ``sample()`` at;
    ``sample()`` may also be driven by hand. ``bundle_dir`` is where
    triggered postmortems land (``dump()``'s default); hooks that
    auto-dump (watchdog trip, CRITICAL health transition) skip when it is
    unset. ``profile_on_trip_s`` seconds of ``torch.profiler`` capture are
    attached to auto-triggered bundles (0 disables)."""

    def __init__(self, registry=None, interval_s: float = 1.0,
                 recent_points: int = 512, decimated_points: int = 512,
                 decimation: int = 8, max_series: int = 1024,
                 histogram_fields: tuple = ("count", "p50", "p99"),
                 bundle_dir: str | None = None,
                 profile_on_trip_s: float = 0.0):
        self._registry = registry or get_registry()
        self.interval_s = float(interval_s)
        self.recent_points = int(recent_points)
        self.decimated_points = int(decimated_points)
        self.decimation = int(decimation)
        self.max_series = int(max_series)
        self.histogram_fields = tuple(histogram_fields)
        self.bundle_dir = bundle_dir
        self.profile_on_trip_s = float(profile_on_trip_s)
        if self.profile_on_trip_s > 0:  # a trip may come on any thread
            from large_scale_recommendation_tpu_torch.obs.introspect import (
                warm_profiler,
            )

            warm_profiler()
        self.samples = 0
        # distinct keys refused past max_series (a set: the same overflow
        # key is refused on every tick), itself capped at max_series
        self._dropped_keys: set[str] = set()
        self.bundles_written = 0
        self.last_bundle: str | None = None
        # the error of the last auto-triggered dump that failed (maybe_dump
        # swallows it: the incident path must not die on its recorder)
        self.last_dump_error: str | None = None
        self._series: dict[str, SeriesRing] = {}
        self._lock = threading.Lock()
        self._task = None
        self._bundle_lock = threading.Lock()

    # -- sampling ------------------------------------------------------------

    def sample(self) -> int:
        """Record one point per live instrument (histograms: one per
        configured field). Returns the number of series touched."""
        snap = self._registry.snapshot()
        t = snap["time"]
        touched = 0
        with self._lock:
            for m in snap["metrics"]:
                if m["type"] in ("counter", "gauge"):
                    touched += self._record(
                        series_key(m["name"], m["labels"]), t, m["value"])
                else:  # histogram: count + quantiles
                    for field in self.histogram_fields:
                        v = m.get(field)
                        if v is None:
                            continue
                        touched += self._record(
                            series_key(m["name"], m["labels"], field), t, v)
            self.samples += 1
        return touched

    @property
    def dropped_series(self) -> int:
        """Distinct series keys refused because the table was full
        (saturates at ``max_series``)."""
        with self._lock:
            return len(self._dropped_keys)

    def _record(self, key: str, t: float, v: float) -> int:
        ring = self._series.get(key)
        if ring is None:
            if len(self._series) >= self.max_series:
                if len(self._dropped_keys) < self.max_series:
                    self._dropped_keys.add(key)
                return 0
            ring = self._series[key] = SeriesRing(
                self.recent_points, self.decimated_points, self.decimation)
        ring.append(t, v)
        return 1

    # -- cadence (the shared PeriodicTask machinery) -------------------------

    def start(self, interval_s: float | None = None) -> "FlightRecorder":
        """Run ``sample()`` every ``interval_s`` on a daemon thread.
        Idempotent at the same cadence; a different cadence restarts it."""
        from large_scale_recommendation_tpu_torch.obs.health import (
            ensure_periodic,
        )

        if interval_s is not None:
            if (self._task is not None and self._task.running
                    and float(interval_s) != self._task.interval_s):
                self.stop()
            self.interval_s = float(interval_s)
        self._task = ensure_periodic(self._task, self.sample,
                                     self.interval_s,
                                     name="flight-recorder")
        return self

    def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.stop()

    @property
    def running(self) -> bool:
        return self._task is not None and self._task.running

    # -- reads ---------------------------------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series_points(self, key: str) -> list[tuple[float, float]]:
        with self._lock:
            ring = self._series.get(key)
            return ring.points() if ring is not None else []

    def series_values(self, key: str,
                      last_n: int | None = None) -> list[float]:
        with self._lock:
            ring = self._series.get(key)
            return ring.values(last_n) if ring is not None else []

    def snapshot(self, name_filter: str | None = None) -> dict:
        """The ``/seriesz`` body (JSON-safe): every series' merged
        old+recent points as ``[[t, v], ...]`` (a non-finite sample as
        ``null``) plus the recorder's own accounting."""
        with self._lock:
            series = {
                key: {"points": [[t, v if math.isfinite(v) else None]
                                 for t, v in ring.points()],
                      "n": len(ring)}
                for key, ring in sorted(self._series.items())
                if name_filter is None or name_filter in key
            }
            return {
                "time": time.time(),
                "interval_s": self.interval_s,
                "samples": self.samples,
                "series_count": len(self._series),
                "max_series": self.max_series,
                "dropped_series": len(self._dropped_keys),
                "tiering": {"recent_points": self.recent_points,
                            "decimated_points": self.decimated_points,
                            "decimation": self.decimation},
                "series": series,
            }

    # -- postmortem bundles --------------------------------------------------

    def dump(self, trigger: str = "manual", detail: dict | None = None,
             directory: str | None = None, monitor=None,
             health_report: dict | None = None) -> str:
        """Write one postmortem bundle and return its path.

        ``directory`` overrides the default
        ``<bundle_dir>/bundle_<trigger>_<seq>``. ``monitor`` /
        ``health_report`` feed ``health.json``. Serialized under a lock,
        so two triggers firing together write two complete bundles."""
        # run the monitor BEFORE taking the bundle lock: run() may detect
        # an ok→CRITICAL transition and auto-dump through maybe_dump, which
        # would deadlock on the (non-reentrant) lock held here
        if health_report is None and monitor is not None:
            health_report = _safe_health_report(monitor)
        with self._bundle_lock:
            if directory is None:
                if self.bundle_dir is None:
                    raise ValueError(
                        "no bundle destination: construct the recorder "
                        "with bundle_dir=... or pass directory=...")
                # never reuse an existing auto-name: a restarted process
                # counts from zero again, and the previous run's bundle is
                # the one that likely explains the restart
                seq = self.bundles_written
                while True:
                    directory = os.path.join(
                        self.bundle_dir, f"bundle_{trigger}_{seq:03d}")
                    if not os.path.exists(directory):
                        break
                    seq += 1
            path = write_bundle(
                directory, trigger=trigger, detail=detail, recorder=self,
                health_report=health_report)
            self.bundles_written += 1
            self.last_bundle = path
        if self.profile_on_trip_s > 0 and trigger != "manual":
            _attach_profile(path, self.profile_on_trip_s)
        return path

    def maybe_dump(self, trigger: str, detail: dict | None = None,
                   monitor=None, health_report: dict | None = None,
                   ) -> str | None:
        """The auto-trigger form (watchdog trip, CRITICAL transition): no
        ``bundle_dir`` → no bundle; a failed write is kept in
        ``last_dump_error`` and answers ``None`` — the incident path must
        never die on its own recorder."""
        if self.bundle_dir is None:
            return None
        try:
            return self.dump(trigger=trigger, detail=detail,
                             monitor=monitor, health_report=health_report)
        except Exception as e:
            self.last_dump_error = repr(e)
            return None


# --------------------------------------------------------------------------
# Bundle writer + schema contract
# --------------------------------------------------------------------------


def _attach_profile(path: str, seconds: float) -> None:
    """A forward-looking ``torch.profiler`` capture into ``<path>/profile``
    (after the bundle is published: a profiler cannot record the past). A
    capture already in flight, or a failing one, leaves ``note.json``
    there instead of voiding the bundle."""
    from large_scale_recommendation_tpu_torch.obs.introspect import (
        capture_profile,
    )

    out = os.path.join(path, "profile")
    try:
        capture_profile(out, seconds)
    except (RuntimeError, OSError) as e:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "note.json"), "w") as f:
            json.dump({"note": f"no profile captured: {e}"}, f)


def _safe_health_report(monitor) -> dict:
    """Run a monitor for a bundle's health.json without letting a broken
    monitor void the bundle."""
    try:
        return monitor.run()
    except Exception as e:
        return {"status": "unknown", "error": repr(e)}


def _device_memory_doc() -> dict:
    """A fresh device-memory sample (bytes in use / peak / limit per card;
    the live-tensor breakdown only on the main thread), or a note doc."""
    from large_scale_recommendation_tpu_torch.obs.introspect import (
        get_introspector,
    )

    introspector = get_introspector()
    if introspector is None:
        return {"note": "no introspector installed", "supported": False,
                "devices": []}
    on_main = threading.current_thread() is threading.main_thread()
    try:
        doc = introspector.sample_device_memory(publish=False,
                                                live_tensors=on_main)
    except Exception as e:  # a failing sampler must not void the bundle
        return {"note": f"sample failed: {e!r}", "supported": False,
                "devices": []}
    if not on_main:
        doc["live_arrays_note"] = (
            "live-tensor walk skipped: bundle written off the main thread "
            f"({threading.current_thread().name})")
    return doc


def _plane_doc(get_plane, absent: dict) -> dict:
    """A plane's snapshot, ``absent`` when it is not installed, a note doc
    (with ``absent``'s empty tables) when its snapshot fails."""
    plane = get_plane()
    if plane is None:
        return absent
    try:
        return plane.snapshot()
    except Exception as e:
        return {**absent, "note": f"snapshot failed: {e!r}"}


def write_bundle(directory: str, *, trigger: str, detail: dict | None = None,
                 recorder: FlightRecorder | None = None, events=None,
                 tracer=None, registry=None, monitor=None,
                 health_report: dict | None = None, span_tail: int = 512,
                 event_tail: int = 1024) -> str:
    """Write one incident bundle ATOMICALLY: everything lands in a temp
    directory first and one ``os.replace`` publishes it — a crash
    mid-write leaves a ``.tmp-*`` orphan, never a half bundle at the final
    path. Returns the final directory."""
    from large_scale_recommendation_tpu_torch.obs.budget import get_budget
    from large_scale_recommendation_tpu_torch.obs.contention import (
        SaturationAnalyzer,
        get_contention,
    )
    from large_scale_recommendation_tpu_torch.obs.lineage import get_lineage
    from large_scale_recommendation_tpu_torch.obs.requests import (
        get_requests,
    )
    from large_scale_recommendation_tpu_torch.obs.store import get_store
    from large_scale_recommendation_tpu_torch.obs.transfers import (
        get_transfers,
    )

    events = events if events is not None else get_events()
    tracer = tracer or get_tracer()
    registry = registry or get_registry()
    created = time.time()

    if health_report is None and monitor is not None:
        health_report = _safe_health_report(monitor)
    if health_report is None:
        health_report = {"status": "unknown",
                         "note": "no health monitor attached"}

    series_doc = (recorder.snapshot() if recorder is not None
                  else {"series": {}, "note": "no flight recorder"})
    device_memory_doc = _device_memory_doc()
    event_lines = events.tail(event_tail) if events is not None else []
    trace_doc = {"traceEvents": tracer.events()[-span_tail:],
                 "displayTimeUnit": "ms"}
    metrics_doc = registry.snapshot()

    def _metric_subset(prefix: str) -> list:
        return [m for m in metrics_doc.get("metrics", [])
                if m.get("name", "").startswith(prefix)]

    # the model plane: catalog-swap provenance plus the latest quality /
    # data-quality instrument values from the same registry snapshot
    lineage_doc = {
        "lineage": _plane_doc(get_lineage,
                              {"note": "no lineage journal installed",
                               "records": []}),
        "quality": _metric_subset("eval_"),
        "data_quality": _metric_subset("dataq_"),
    }

    def _saturation():
        tracker = get_contention()
        return (None if tracker is None
                else SaturationAnalyzer(tracker, registry=registry))

    contention_doc = _plane_doc(_saturation,
                                {"note": "no contention tracker installed",
                                 "locks": [], "partitions": {}})
    budget_doc = _plane_doc(get_budget, {"note": "rollout budget not enabled",
                                         "cohorts": {}})
    requests_doc = _plane_doc(get_requests,
                              {"note": "request telemetry not enabled",
                               "exemplars": []})
    store_doc = _plane_doc(get_store, {"note": "no tiered store installed",
                                       "tiers": {}})
    transfers_doc = _plane_doc(get_transfers,
                               {"note": "transfer ledger not enabled",
                                "sites": {}})
    config_doc = {
        "time": created,
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": sys.version,
        "platform": platform.platform(),
        "cwd": os.getcwd(),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(_ENV_PREFIXES)},
    }
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "created": created,
        "trigger": str(trigger),
        "detail": detail or {},
        "files": list(BUNDLE_FILES),
        "counts": {"series": len(series_doc.get("series", {})),
                   "events": len(event_lines),
                   "spans": len(trace_doc["traceEvents"])},
    }
    docs = {"series.json": series_doc, "trace.json": trace_doc,
            "health.json": health_report, "metrics.json": metrics_doc,
            "config.json": config_doc,
            "device_memory.json": device_memory_doc,
            "lineage.json": lineage_doc, "contention.json": contention_doc,
            "store.json": store_doc, "transfers.json": transfers_doc,
            "budget.json": budget_doc, "requests.json": requests_doc}

    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(directory) + ".tmp-",
                           dir=parent)
    try:
        def _write_json(name, doc):
            # _json_safe: NaN/Infinity must not land as python's
            # non-RFC-8259 tokens — the bundle is built for strict parsers
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(_json_safe(doc), f, indent=2, default=repr)

        with open(os.path.join(tmp, "events.jsonl"), "w") as f:
            for ev in event_lines:
                f.write(json.dumps(_json_safe(ev), default=repr) + "\n")
        for name, doc in docs.items():
            _write_json(name, doc)
        _write_json("manifest.json", manifest)
        if os.path.isdir(directory):  # a re-dump to the same explicit path
            shutil.rmtree(directory)
        os.replace(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return directory


def load_bundle(directory: str) -> dict:
    """Load AND validate one postmortem bundle (the JAX package's schema
    contract, check for check): the manifest, every required file's
    presence and JSON shape, the trace tail against
    ``validate_chrome_trace``, and the series point form. Returns every
    parsed document keyed by stem. Raises ``ValueError`` on violation."""
    from large_scale_recommendation_tpu_torch.obs.trace import (
        validate_chrome_trace,
    )

    def _load(name):
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            raise ValueError(f"bundle {directory}: missing {name}")
        with open(path) as f:
            text = f.read()
        if name.endswith(".jsonl"):
            return [json.loads(ln) for ln in text.splitlines() if ln.strip()]
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"bundle {directory}: {name} is not valid "
                             f"JSON: {e}") from e

    def _require_object(name, doc, keys):
        if not isinstance(doc, dict):
            raise ValueError(f"bundle {directory}: {name} is not a JSON "
                             "object")
        if not any(k in doc for k in keys):
            raise ValueError(f"bundle {directory}: {name} has none of "
                             f"{keys}")

    manifest = _load("manifest.json")
    version = manifest.get("bundle_version")
    required_files = _BUNDLE_FILES_BY_VERSION.get(version)
    if required_files is None:
        raise ValueError(f"bundle {directory}: unsupported bundle_version "
                         f"{version!r}")
    for key in ("created", "trigger", "files", "counts"):
        if key not in manifest:
            raise ValueError(f"bundle {directory}: manifest missing {key!r}")
    for name in required_files:
        if name not in manifest["files"]:
            raise ValueError(
                f"bundle {directory}: manifest does not list {name}")

    series = _load("series.json")
    if not isinstance(series.get("series"), dict):
        raise ValueError(f"bundle {directory}: series.json has no series "
                         "mapping")
    for key, s in series["series"].items():
        pts = s.get("points")
        if not isinstance(pts, list) or any(
                not (isinstance(p, list) and len(p) == 2
                     and isinstance(p[0], (int, float))
                     and (p[1] is None or isinstance(p[1], (int, float))))
                for p in pts):
            raise ValueError(f"bundle {directory}: series {key!r} points "
                             "are not [t, number|null] pairs")

    events = _load("events.jsonl")
    for ev in events:
        for key in ("time", "kind", "severity", "detail"):
            if key not in ev:
                raise ValueError(
                    f"bundle {directory}: event missing {key!r}: {ev!r}")

    trace = _load("trace.json")
    validate_chrome_trace(trace)

    health = _load("health.json")
    if not isinstance(health.get("status"), str):
        raise ValueError(f"bundle {directory}: health.json has no status")
    metrics = _load("metrics.json")
    if not isinstance(metrics.get("metrics"), list):
        raise ValueError(f"bundle {directory}: metrics.json has no metrics "
                         "list")
    config = _load("config.json")
    if not isinstance(config.get("env"), dict):
        raise ValueError(f"bundle {directory}: config.json has no env map")
    if "device_memory.json" in required_files:
        device_memory = _load("device_memory.json")
        if not isinstance(device_memory.get("devices"), list):
            raise ValueError(f"bundle {directory}: device_memory.json has "
                             "no devices list")
    else:  # a version-1 bundle predates the device-memory freeze
        device_memory = {"note": "version-1 bundle (no device memory "
                                 "sample)", "supported": False,
                         "devices": []}
    if "lineage.json" in required_files:
        lineage = _load("lineage.json")
        for key in ("lineage", "quality", "data_quality"):
            if key not in lineage:
                raise ValueError(f"bundle {directory}: lineage.json "
                                 f"missing {key!r}")
        if not isinstance(lineage["lineage"].get("records"), list):
            raise ValueError(f"bundle {directory}: lineage.json lineage "
                             "has no records list")
    else:
        lineage = {"note": f"version-{version} bundle (no lineage/quality "
                           "freeze)",
                   "lineage": {"records": []}, "quality": [],
                   "data_quality": []}
    if "contention.json" in required_files:
        contention = _load("contention.json")
        if not isinstance(contention.get("locks"), list):
            raise ValueError(f"bundle {directory}: contention.json has "
                             "no locks list")
    else:
        contention = {"note": f"version-{version} bundle (no contention "
                              "freeze)", "locks": [], "partitions": {}}
    if "store.json" in required_files:
        store = _load("store.json")
        _require_object("store.json", store, ("hot", "note"))
    else:
        store = {"note": f"version-{version} bundle (no store freeze)",
                 "tiers": {}}
    if "transfers.json" in required_files:
        transfers = _load("transfers.json")
        _require_object("transfers.json", transfers, ("sites", "note"))
    else:
        transfers = {"note": f"version-{version} bundle (no transfer "
                             "freeze)", "sites": {}}
    if "budget.json" in required_files:
        budget = _load("budget.json")
        _require_object("budget.json", budget, ("cohorts", "note"))
    else:
        budget = {"note": f"version-{version} bundle (no budget freeze)",
                  "cohorts": {}}
    if "requests.json" in required_files:
        requests = _load("requests.json")
        _require_object("requests.json", requests, ("exemplars", "note"))
    else:
        requests = {"note": f"version-{version} bundle (no request "
                            "freeze)", "exemplars": []}
    return {"manifest": manifest, "series": series, "events": events,
            "trace": trace, "health": health, "metrics": metrics,
            "config": config, "device_memory": device_memory,
            "lineage": lineage, "contention": contention,
            "store": store, "transfers": transfers, "budget": budget,
            "requests": requests}


def validate_bundle(directory: str) -> dict:
    """Validate a bundle and return its manifest (the check-only form of
    ``load_bundle``). Raises ``ValueError`` on violation."""
    return load_bundle(directory)["manifest"]


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by enable helpers
# --------------------------------------------------------------------------

_RECORDER: FlightRecorder | None = None


def get_recorder() -> FlightRecorder | None:
    """The installed flight recorder or ``None``. Incident hooks (watchdog
    trip, health transitions) resolve this lazily, so construction order
    between the recorder and its triggers never matters."""
    return _RECORDER


def set_recorder(recorder: FlightRecorder | None) -> None:
    global _RECORDER
    _RECORDER = recorder
