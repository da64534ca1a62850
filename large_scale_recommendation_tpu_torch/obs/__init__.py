"""Observability (counterpart of ``large_scale_recommendation_tpu.obs``):
the base planes and the planes that touch the device.

- ``obs.registry`` — ``MetricsRegistry`` of labeled counters, gauges and
  log-bucketed histograms, with snapshot / JSONL / Prometheus exporters
  (the JAX package's, output for output).
- ``obs.trace`` — nested-span ``Tracer`` exporting Chrome trace JSON;
  ``span.out`` makes a span wait for its CUDA work on the producing stream
  before the clock stops, and a compile key splits first (``compile``) and
  steady (``execute``) calls. ``Tracer.install_build_hook`` publishes the
  kernel libraries' builds and loads (``kernel_build_s{library=}``). A
  span is *live* when the tracer is enabled or a ``torch.profiler``
  capture records (one flag read). A live span opens a host profiler range
  of its name (``_RecordFunctionFast``, not ``record_function``). A
  ``record_function`` range would be a user annotation, which Kineto
  mirrors onto the device timeline as if it were device work. A live span
  also adds its wall, self time, numeric args and, with ``device=True``, a
  CUDA event pair's ms to ``span_totals()``. The program's layers open
  such spans (``online/ensure``, ``dsgd/blocking``, ``als/solve``,
  ``serving/lookup``, ...), so a device trace names the host phase around
  each idle gap.
- ``obs.events`` — the ring-bounded, span-correlated ``EventJournal``.
- ``obs.instrument`` — ``TrainSegmentTimer``, the per-segment timing and
  throughput of every batch trainer.
- ``obs.health`` — ``HealthMonitor``, ``SLOTracker``, ``TrainingWatchdog``.
- ``obs.introspect`` — kernel records from the launchers joined with the
  measured walls into a roofline at the card's peaks, device-memory
  samples, ``torch.profiler`` capture.
- ``obs.transfers`` — the host↔device ledger, the sync-debug guard and the
  library-reload watch.
- ``obs.quality`` — the ``OnlineEvaluator``.
- ``obs.recorder`` — the ``FlightRecorder`` (bounded per-series history
  of every instrument) and the postmortem bundles (``write_bundle`` /
  ``load_bundle`` / ``validate_bundle``: the JAX package's schema and
  version, readable by either package).
- ``obs.anomaly`` — threshold-free checks over the recorder's series
  (``AnomalyCheck``, ``MonotonicGrowthCheck``).
- ``obs.store`` — the STORE plane (the tiered factor store's ``/storez``).
- ``obs.dataquality`` / ``obs.lineage`` — the ingest data-quality gate
  (``DataQualityInspector`` behind ``DataQualityCheck``) and the catalog
  provenance journal (``LineageJournal``: every swap stamped, every flush
  joined, the ``FreshnessCheck`` SLO; ``/lineagez``).
- ``obs.disttrace`` — record trace identity from WAL offsets, pod trace
  assembly and the ingest→servable ``CriticalPathAnalyzer``
  (``/criticalpathz``, the fleet's ``/podtracez``).
- ``obs.contention`` — named instrumented locks, the thread sampler and
  the Amdahl ``SaturationAnalyzer`` (``/contentionz``).
- ``obs.budget`` — the ROLLOUT plane: multi-window error budgets,
  per-catalog-version cohorts and canary verdicts (``/budgetz``).
- ``obs.requests`` — the REQUEST plane: per-flush stage ledgers and
  tail-based exemplars (``/slowz``).
- ``obs.server`` — ``ObsServer``: ``/metrics``, ``/healthz``, ``/varz``,
  ``/tracez``, ``/seriesz``, ``/eventz``, ``/rooflinez``, ``/lineagez``,
  ``/criticalpathz``, ``/contentionz``, ``/storez``, ``/transferz``,
  ``/budgetz``, ``/slowz``, ``/profilez``.
- ``obs.fleet`` — ``FleetAggregator`` / ``FleetServer``: every process's
  endpoints merged into one pod view.

Zero-cost when disabled: the module defaults are a ``NullRegistry`` and a
``NullTracer`` whose instruments are shared stateless singletons (a span
is the shared no-op unless a profiler records), the
introspector, journal, ledger, recorder and store default to ``None``,
and call sites cache ``registry.enabled`` at construction — off, a fit
reads no clock, records no CUDA event and waits on no stream for obs,
and no sampler thread runs.

Usage::

    from large_scale_recommendation_tpu_torch import obs

    reg, tracer = obs.enable()   # before building the models to observe
    recorder, journal = obs.enable_flight_recorder(interval_s=1.0,
                                                   bundle_dir="bundles")
    obs.enable_lineage(); obs.enable_disttrace()
    obs.enable_budget(target_s=0.05); obs.enable_requests(target_s=0.05)
    obs.enable_contention(interval_s=1.0)
    server = obs.ObsServer(monitor=obs.HealthMonitor()).start()
    ...
    print(reg.to_prometheus())
    tracer.to_chrome_trace("trace.json")
    server.stop()
    obs.disable()
"""

from __future__ import annotations

from large_scale_recommendation_tpu_torch.obs.anomaly import (
    AnomalyCheck,
    MonotonicGrowthCheck,
    ewma_zscore,
    rate_of_change,
)
from large_scale_recommendation_tpu_torch.obs.budget import (
    CanaryVerdictEngine,
    RolloutBudget,
    RolloutCheck,
    budgetz,
    get_budget,
    serve_scope,
    set_budget,
)
from large_scale_recommendation_tpu_torch.obs.contention import (
    ContentionTracker,
    InstrumentedCondition,
    InstrumentedLock,
    InstrumentedRLock,
    SaturationAnalyzer,
    amdahl_speedup,
    get_contention,
    karp_flatt_serial_fraction,
    named_condition,
    named_lock,
    named_rlock,
    set_contention,
)
from large_scale_recommendation_tpu_torch.obs.dataquality import (
    DataQualityInspector,
)
from large_scale_recommendation_tpu_torch.obs.disttrace import (
    CriticalPathAnalyzer,
    assemble_pod_trace,
    get_disttrace,
    record_trace_id,
    resolve_record_trace,
    set_disttrace,
)
from large_scale_recommendation_tpu_torch.obs.events import (
    EventJournal,
    get_events,
    set_events,
)
from large_scale_recommendation_tpu_torch.obs.fleet import (
    FleetAggregator,
    FleetServer,
    merge_prometheus,
    parse_prometheus,
)
from large_scale_recommendation_tpu_torch.obs.health import (
    CRITICAL,
    DEGRADED,
    OK,
    CheckResult,
    DataQualityCheck,
    HealthMonitor,
    SLOTracker,
    TrainingDivergedError,
    TrainingWatchdog,
)
from large_scale_recommendation_tpu_torch.obs.introspect import (
    Introspector,
    capture_profile,
    get_introspector,
    profile_trace,
    set_introspector,
)
from large_scale_recommendation_tpu_torch.obs.lineage import (
    FreshnessCheck,
    LineageJournal,
    get_lineage,
    set_lineage,
)
from large_scale_recommendation_tpu_torch.obs.quality import (
    OnlineEvaluator,
    catalog_coverage,
    sampled_ranking_metrics,
)
from large_scale_recommendation_tpu_torch.obs.recorder import (
    FlightRecorder,
    get_recorder,
    load_bundle,
    series_key,
    set_recorder,
    validate_bundle,
    write_bundle,
)
from large_scale_recommendation_tpu_torch.obs.registry import (
    MetricsRegistry,
    NullRegistry,
    get_registry,
    set_registry,
)
from large_scale_recommendation_tpu_torch.obs.requests import (
    FlushLedger,
    RequestStageCheck,
    RequestTelemetry,
    get_requests,
    request_scope,
    set_requests,
    slowz,
)
from large_scale_recommendation_tpu_torch.obs.server import ObsServer
from large_scale_recommendation_tpu_torch.obs.store import (
    get_store,
    set_store,
    storez,
)
from large_scale_recommendation_tpu_torch.obs.trace import (
    NullTracer,
    TraceContext,
    Tracer,
    get_tracer,
    process_namespace,
    reset_span_totals,
    set_tracer,
    span_totals,
    validate_chrome_trace,
)
from large_scale_recommendation_tpu_torch.obs.transfers import (
    TransferLedger,
    get_transfers,
    set_transfers,
    transferz,
)

__all__ = [
    "MetricsRegistry",
    "NullRegistry",
    "Tracer",
    "NullTracer",
    "get_registry",
    "set_registry",
    "get_tracer",
    "set_tracer",
    "span_totals",
    "reset_span_totals",
    "validate_chrome_trace",
    "enable",
    "disable",
    "enabled",
    "enable_flight_recorder",
    "enable_introspection",
    "Introspector",
    "get_introspector",
    "set_introspector",
    "capture_profile",
    "profile_trace",
    "FleetAggregator",
    "FleetServer",
    "merge_prometheus",
    "parse_prometheus",
    "FlightRecorder",
    "EventJournal",
    "AnomalyCheck",
    "MonotonicGrowthCheck",
    "ewma_zscore",
    "rate_of_change",
    "get_recorder",
    "set_recorder",
    "get_events",
    "set_events",
    "series_key",
    "validate_bundle",
    "load_bundle",
    "write_bundle",
    "HealthMonitor",
    "CheckResult",
    "SLOTracker",
    "TrainingWatchdog",
    "TrainingDivergedError",
    "DataQualityCheck",
    "DataQualityInspector",
    "OnlineEvaluator",
    "sampled_ranking_metrics",
    "catalog_coverage",
    "LineageJournal",
    "FreshnessCheck",
    "get_lineage",
    "set_lineage",
    "enable_lineage",
    "ContentionTracker",
    "SaturationAnalyzer",
    "InstrumentedLock",
    "InstrumentedRLock",
    "InstrumentedCondition",
    "karp_flatt_serial_fraction",
    "amdahl_speedup",
    "named_lock",
    "named_rlock",
    "named_condition",
    "get_contention",
    "set_contention",
    "enable_contention",
    "TraceContext",
    "process_namespace",
    "CriticalPathAnalyzer",
    "assemble_pod_trace",
    "resolve_record_trace",
    "record_trace_id",
    "get_disttrace",
    "set_disttrace",
    "enable_disttrace",
    "ObsServer",
    "get_store",
    "set_store",
    "storez",
    "TransferLedger",
    "get_transfers",
    "set_transfers",
    "transferz",
    "enable_transfers",
    "RolloutBudget",
    "CanaryVerdictEngine",
    "RolloutCheck",
    "get_budget",
    "set_budget",
    "serve_scope",
    "budgetz",
    "enable_budget",
    "RequestTelemetry",
    "FlushLedger",
    "RequestStageCheck",
    "get_requests",
    "set_requests",
    "request_scope",
    "slowz",
    "enable_requests",
    "OK",
    "DEGRADED",
    "CRITICAL",
]


def enable(registry: MetricsRegistry | None = None,
           tracer: Tracer | None = None):
    """Install a live registry + tracer as the module-level defaults.

    Returns ``(registry, tracer)``. Instrumented components read the
    defaults at construction time, so enable BEFORE building the models
    you want instrumented."""
    registry = registry or MetricsRegistry()
    tracer = tracer or Tracer()
    set_registry(registry)
    set_tracer(tracer)
    return registry, tracer


def enable_flight_recorder(interval_s: float = 1.0,
                           bundle_dir: str | None = None,
                           event_capacity: int = 4096,
                           event_jsonl: str | None = None,
                           start: bool = True,
                           **recorder_kwargs):
    """Install the flight-recorder layer: an ``EventJournal`` as the
    module-level journal and a ``FlightRecorder`` as the module-level
    recorder (started unless ``start=False``). Call AFTER ``enable()``
    (the recorder samples the live registry; the journal stamps the live
    tracer's span ids) and BEFORE building the models and drivers whose
    emissions you want journaled. Returns ``(recorder, journal)``."""
    prev = get_recorder()
    if prev is not None:  # re-enable must not leak the old sampler
        prev.stop()
    journal = EventJournal(capacity=event_capacity, jsonl_path=event_jsonl)
    set_events(journal)
    recorder = FlightRecorder(interval_s=interval_s, bundle_dir=bundle_dir,
                              **recorder_kwargs)
    set_recorder(recorder)
    if start:
        recorder.start()
    return recorder, journal


def enable_introspection(interval_s: float = 1.0, start: bool = True,
                         **introspector_kwargs) -> Introspector:
    """Install an ``Introspector`` as the module-level default (the step
    pair's launchers note their records into it), with its device-memory
    / roofline sampler running every ``interval_s`` unless
    ``start=False``. Call AFTER ``enable()`` (it binds the live registry
    and tracer at construction). Returns the introspector."""
    prev = get_introspector()
    if prev is not None:  # re-enable must not leak the old sampler
        prev.close()
    introspector = Introspector(**introspector_kwargs)
    set_introspector(introspector)
    if start:
        introspector.start(interval_s)
    return introspector


def enable_lineage(capacity: int = 1024,
                   ingest_marks: int = 512) -> LineageJournal:
    """Install a ``LineageJournal`` as the module-level default: the
    catalog-provenance layer every swap site stamps and every engine flush
    joins against. Call AFTER ``enable()`` (it binds the live registry)
    and BEFORE building the engines and drivers whose swaps you want
    stamped. Returns the journal (``/lineagez``)."""
    journal = LineageJournal(capacity=capacity, ingest_marks=ingest_marks)
    set_lineage(journal)
    return journal


def enable_disttrace(capacity: int = 256,
                     marks: int = 1024) -> CriticalPathAnalyzer:
    """Install a ``CriticalPathAnalyzer`` as the module-level default: the
    ingest→servable critical-path layer the WAL, driver, adaptive and
    engine tiers stamp. Call AFTER ``enable()`` and BEFORE building the
    logs, drivers and engines whose path you want attributed. Returns the
    analyzer (``/criticalpathz``)."""
    analyzer = CriticalPathAnalyzer(capacity=capacity, marks=marks)
    set_disttrace(analyzer)
    return analyzer


def enable_contention(interval_s: float = 1.0, start: bool = True,
                      **tracker_kwargs) -> ContentionTracker:
    """Install a ``ContentionTracker`` as the module-level default: the
    concurrency plane every ``named_lock`` / ``named_rlock`` /
    ``named_condition`` site resolves. Call AFTER ``enable()`` and BEFORE
    building the models, engines and drivers whose locks you want
    instrumented (primitives bind at construction). Starts the thread
    sampler unless ``start=False``. Returns the tracker
    (``/contentionz``)."""
    prev = get_contention()
    if prev is not None:  # re-enable must not leak the old sampler
        prev.stop()
    tracker = ContentionTracker(**tracker_kwargs)
    set_contention(tracker)
    if start:
        tracker.start(interval_s)
    return tracker


def enable_transfers(guard: str = "off", watch_hot: bool = True,
                     **ledger_kwargs) -> TransferLedger:
    """Install a ``TransferLedger`` as the module-level default: the
    named-site ledger, the sync-debug guard the hot paths scope
    (``guard``: ``"off"`` / ``"log"`` / ``"disallow"``) and, with
    ``watch_hot``, the reload watch over the kernel libraries
    (``ops._build.LibraryWatch`` of ``dsgd_sweep`` and ``fastblock``).
    Call AFTER ``enable()``. Returns the ledger."""
    ledger = TransferLedger(guard_mode=guard, **ledger_kwargs)
    set_transfers(ledger)
    if watch_hot:
        from large_scale_recommendation_tpu_torch.ops import _build

        for name in ("dsgd_sweep", "fastblock"):
            ledger.watch(name, _build.LibraryWatch(name))
    return ledger


def enable_budget(target_s: float, objective: float = 0.99,
                  **budget_kwargs) -> RolloutBudget:
    """Install a ``RolloutBudget`` as the module-level default: the
    ROLLOUT plane the serving seams note version-keyed outcomes into and
    the canary verdict engine decides over. ``target_s`` / ``objective``
    define the latency SLO the budget burns against; ``budget_kwargs``
    pass through (window sizes, cohort bounds, verdict thresholds). Call
    AFTER ``enable()`` and BEFORE building the engines whose outcomes you
    want attributed. Returns the budget (``/budgetz``)."""
    budget = RolloutBudget(target_s, objective=objective, **budget_kwargs)
    set_budget(budget)
    return budget


def enable_requests(target_s: float, objective: float = 0.99,
                    **telemetry_kwargs) -> RequestTelemetry:
    """Install a ``RequestTelemetry`` as the module-level default: the
    REQUEST plane the serving seams mark stage ledgers into and the tail
    exemplars land in. Give it the same ``target_s`` as the engine's
    ``SLOTracker`` so the exemplar p99 and the SLO reservoir price one
    stream; ``telemetry_kwargs`` pass through (``window``,
    ``max_exemplars``, ``slow_keep``). Call AFTER ``enable()`` and BEFORE
    building the engines whose requests you want decomposed. Returns the
    telemetry (``/slowz``)."""
    telemetry = RequestTelemetry(target_s, objective=objective,
                                 **telemetry_kwargs)
    set_requests(telemetry)
    return telemetry


def disable() -> None:
    """Restore the zero-cost defaults: null registry/tracer, no flight
    recorder, introspector or contention tracker (their samplers stopped
    first), no journal, lineage journal, critical-path analyzer, store
    plane, transfer ledger, rollout budget or request telemetry, no library
    build hook; the sync-debug mode is left at 0."""
    from large_scale_recommendation_tpu_torch.obs import registry as _r
    from large_scale_recommendation_tpu_torch.obs import trace as _t
    from large_scale_recommendation_tpu_torch.obs import transfers as _x
    from large_scale_recommendation_tpu_torch.ops import _build

    recorder = get_recorder()
    if recorder is not None:
        recorder.stop()
    introspector = get_introspector()
    if introspector is not None:
        introspector.close()
    contention = get_contention()
    if contention is not None:
        contention.stop()
    set_contention(None)
    set_introspector(None)
    set_recorder(None)
    set_events(None)
    set_lineage(None)
    set_disttrace(None)
    set_store(None)
    set_transfers(None)
    set_budget(None)
    set_requests(None)
    _build.set_build_hook(None)
    _x._set_sync_debug_mode(0)
    set_registry(_r.NULL_REGISTRY)
    set_tracer(_t.NULL_TRACER)


def enabled() -> bool:
    """Whether a live (non-null) registry is currently installed."""
    return get_registry().enabled
