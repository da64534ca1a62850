"""Observability (counterpart of ``large_scale_recommendation_tpu.obs``):
the base planes and the planes that touch the device.

- ``obs.registry`` — ``MetricsRegistry`` of labeled counters, gauges and
  log-bucketed histograms, with snapshot / JSONL / Prometheus exporters
  (the JAX package's, output for output).
- ``obs.trace`` — nested-span ``Tracer`` exporting Chrome trace JSON;
  ``span.out`` makes a span wait for its CUDA work on the producing stream
  before the clock stops, and a compile key splits first (``compile``) and
  steady (``execute``) calls. ``Tracer.install_build_hook`` publishes the
  kernel libraries' builds and loads (``kernel_build_s{library=}``).
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

Zero-cost when disabled: the module defaults are a ``NullRegistry`` and a
``NullTracer`` whose instruments are shared stateless singletons, the
introspector, journal and ledger default to ``None``, and call sites cache
``registry.enabled`` at construction — off, a fit reads no clock, records
no CUDA event and waits on no stream for obs.

Usage::

    from large_scale_recommendation_tpu_torch import obs

    reg, tracer = obs.enable()   # before building the models to observe
    ...
    print(reg.to_prometheus())
    tracer.to_chrome_trace("trace.json")
    obs.disable()

Not ported yet (ROADMAP queue A, items 6b and 6c): the flight recorder,
anomaly checks, endpoint server and fleet view; the lineage, distributed
tracing, request, budget, contention and data-quality planes.
"""

from __future__ import annotations

from large_scale_recommendation_tpu_torch.obs.events import (
    EventJournal,
    get_events,
    set_events,
)
from large_scale_recommendation_tpu_torch.obs.health import (
    CRITICAL,
    DEGRADED,
    OK,
    CheckResult,
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
from large_scale_recommendation_tpu_torch.obs.quality import (
    OnlineEvaluator,
    catalog_coverage,
    sampled_ranking_metrics,
)
from large_scale_recommendation_tpu_torch.obs.registry import (
    MetricsRegistry,
    NullRegistry,
    get_registry,
    set_registry,
)
from large_scale_recommendation_tpu_torch.obs.trace import (
    NullTracer,
    TraceContext,
    Tracer,
    get_tracer,
    process_namespace,
    set_tracer,
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
    "validate_chrome_trace",
    "enable",
    "disable",
    "enabled",
    "enable_introspection",
    "Introspector",
    "get_introspector",
    "set_introspector",
    "capture_profile",
    "profile_trace",
    "EventJournal",
    "get_events",
    "set_events",
    "HealthMonitor",
    "CheckResult",
    "SLOTracker",
    "TrainingWatchdog",
    "TrainingDivergedError",
    "OnlineEvaluator",
    "sampled_ranking_metrics",
    "catalog_coverage",
    "TraceContext",
    "process_namespace",
    "TransferLedger",
    "get_transfers",
    "set_transfers",
    "transferz",
    "enable_transfers",
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


def disable() -> None:
    """Restore the zero-cost defaults: null registry/tracer, no journal,
    no introspector (its sampler stopped first), no transfer ledger, no
    library build hook; the sync-debug mode is left at 0."""
    from large_scale_recommendation_tpu_torch.obs import registry as _r
    from large_scale_recommendation_tpu_torch.obs import trace as _t
    from large_scale_recommendation_tpu_torch.obs import transfers as _x
    from large_scale_recommendation_tpu_torch.ops import _build

    introspector = get_introspector()
    if introspector is not None:
        introspector.close()
    set_introspector(None)
    set_events(None)
    set_transfers(None)
    _build.set_build_hook(None)
    _x._set_sync_debug_mode(0)
    set_registry(_r.NULL_REGISTRY)
    set_tracer(_t.NULL_TRACER)


def enabled() -> bool:
    """Whether a live (non-null) registry is currently installed."""
    return get_registry().enabled
