"""Live health layer: pluggable checks, SLO error budgets, the training
watchdog (counterpart of ``large_scale_recommendation_tpu.obs.health``).

- ``HealthMonitor`` — named checks, each a callable returning a
  ``CheckResult`` (``OK`` / ``DEGRADED`` / ``CRITICAL``). ``run()``
  evaluates every check (a check that *raises* is itself a ``CRITICAL``
  finding), publishes ``health_check_status{check=}`` / ``health_status``
  gauges, journals each aggregate transition, and returns the report.
  Worst status wins.
- ``SLOTracker`` — sliding-window latency-target attainment + error
  budget; ``ServingEngine(slo=...)`` records every flush wall into it.
- ``TrainingWatchdog`` — the divergence guard: non-finite scans of the
  rows each online micro-batch touched, of whole tables at DSGD segment
  boundaries and of retrained factors before a catalog swap, and a
  rising-loss window fed via ``observe_loss``; on a trip the policy runs:
  observe, halt (raise ``TrainingDivergedError``) or rollback (restore
  the last ``save_online_state`` snapshot, then raise).
- ``PeriodicTask`` / ``ensure_periodic`` — the daemon-thread cadence the
  introspector and the online evaluator run on.

A scan is one ``torch.isfinite(...).all()`` read per table (or per
touched-row gather). The JAX watchdog pads the touched-row index to a
power of two to bound XLA recompiles; torch compiles nothing per shape,
so the port gathers the rows as they are.

Postmortems: an entry into CRITICAL (``_on_transition``) and a watchdog
trip look the flight recorder up lazily (``obs.recorder.get_recorder``)
and freeze a bundle when one with a ``bundle_dir`` is installed; the trip's
path lands in ``TrainingWatchdog.last_bundle``. The threshold-free
watches over the recorder's series are ``watch_series``,
``watch_device_memory`` (the ``device_bytes_in_use{device="cuda:0"}``
series on the card), ``watch_store_memory`` and ``watch_quality``.

Not ported yet (a later slice, with the planes they watch): the
``watch_data_quality``, ``watch_freshness``, ``watch_rollout`` and
``watch_requests`` conveniences with ``DataQualityCheck``.

Zero-cost when unused: every hook is an ``is not None`` test on the hot
path (``model.watchdog``, ``engine._slo``), and with the null registry
installed the monitor and tracker publish nothing.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.obs.registry import get_registry

# status constants, ordered by severity; the aggregate is the max
OK = "ok"
DEGRADED = "degraded"
CRITICAL = "critical"
SEVERITY = {OK: 0, DEGRADED: 1, CRITICAL: 2}


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One check's verdict: a status constant plus free-form detail."""

    status: str
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.status not in SEVERITY:
            raise ValueError(f"unknown health status {self.status!r}")


def ok(**detail) -> CheckResult:
    return CheckResult(OK, detail)


def degraded(**detail) -> CheckResult:
    return CheckResult(DEGRADED, detail)


def critical(**detail) -> CheckResult:
    return CheckResult(CRITICAL, detail)


class HealthMonitor:
    """Named health checks, aggregated worst-status-wins.

    ``register(name, check)`` takes any callable returning a
    ``CheckResult``; the built-in check classes below are callables, so
    ``monitor.register("stream", StreamHealthCheck(driver))`` works, as
    do the ``watch_*`` conveniences. ``run()`` is the pull surface
    (``/healthz`` calls it per request): evaluate everything, publish
    status gauges, return the report dict. Thread-safe: registration
    and runs may interleave from server/worker threads.
    """

    def __init__(self, registry=None):
        self._checks: dict[str, Callable[[], CheckResult]] = {}
        self._lock = threading.Lock()
        self._obs = registry or get_registry()
        # last aggregate status, for transition events + the CRITICAL
        # postmortem trigger (obs.recorder) — a persistent CRITICAL
        # dumps ONE bundle at the transition, not one per scrape
        self._last_status: str | None = None

    def register(self, name: str, check: Callable[[], CheckResult]) -> None:
        with self._lock:
            self._checks[name] = check

    def unregister(self, name: str) -> None:
        with self._lock:
            self._checks.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._checks)

    # -- conveniences: wire the built-ins in one call -----------------------

    def watch_watchdog(self, watchdog: "TrainingWatchdog",
                       name: str = "training") -> None:
        self.register(name, watchdog.check)

    def watch_slo(self, slo: "SLOTracker", name: str = "serving",
                  critical_burn: float = 2.0) -> None:
        self.register(name, ServingHealthCheck(slo,
                                               critical_burn=critical_burn))

    def watch_driver(self, driver, name: str = "stream", **thresholds) -> None:
        self.register(name, StreamHealthCheck(driver, **thresholds))

    def watch_checkpoints(self, manager, degraded_after_s: float,
                          critical_after_s: float | None = None,
                          name: str = "checkpoint") -> None:
        self.register(name, CheckpointStalenessCheck(
            manager, degraded_after_s, critical_after_s))

    def watch_series(self, recorder, series: str, name: str | None = None,
                     **kwargs) -> None:
        """Register an ``obs.anomaly.AnomalyCheck`` over one flight-recorder
        series — threshold-free: the check learns the series' recent normal
        and flags departures from it."""
        from large_scale_recommendation_tpu_torch.obs.anomaly import (
            AnomalyCheck,
        )

        self.register(name or f"anomaly:{series}",
                      AnomalyCheck(recorder, series, **kwargs))

    def watch_device_memory(self, recorder, name: str = "device_memory",
                            **kwargs) -> None:
        """Register an ``obs.anomaly.MonotonicGrowthCheck`` over the
        per-card memory series (``device_bytes_in_use{device="cuda:0"}``,
        published by ``obs.introspect``): sustained monotonic growth — the
        leak signature EWMA can't see — degrades ``/healthz``; no series
        (the CPU) stays OK."""
        from large_scale_recommendation_tpu_torch.obs.anomaly import (
            MonotonicGrowthCheck,
        )

        self.register(name, MonotonicGrowthCheck(recorder, **kwargs))

    def watch_store_memory(self, recorder, name: str = "store_memory",
                           **kwargs) -> None:
        """Register an ``obs.anomaly.MonotonicGrowthCheck`` over the tiered
        factor store's host-RAM footprint (``tier_host_bytes``, published
        by ``store.TieredFactorStore``): sustained unbounded growth of the
        cold tier is the host-side leak / runaway-vocabulary signature. No
        series (no tiered store) stays OK."""
        from large_scale_recommendation_tpu_torch.obs.anomaly import (
            MonotonicGrowthCheck,
        )

        self.register(name, MonotonicGrowthCheck(
            recorder, series_prefix="tier_host_bytes", **kwargs))

    def watch_quality(self, recorder, source: str = "online",
                      k: int = 10, name_prefix: str = "quality",
                      **kwargs) -> None:
        """Watch the ``obs.quality.OnlineEvaluator``'s series with the
        threshold-free anomaly checks: ``eval_rmse`` pages on spikes,
        ``eval_ndcg_at_k`` on drops, each learning the model's own recent
        normal. ``kwargs`` pass through to both checks."""
        from large_scale_recommendation_tpu_torch.obs.anomaly import (
            AnomalyCheck,
        )
        from large_scale_recommendation_tpu_torch.obs.recorder import (
            series_key,
        )

        rmse_series = series_key("eval_rmse", {"source": source})
        ndcg_series = series_key("eval_ndcg_at_k",
                                 {"source": source, "k": k})
        self.register(f"{name_prefix}:rmse",
                      AnomalyCheck(recorder, rmse_series,
                                   direction="spike", **kwargs))
        self.register(f"{name_prefix}:ndcg",
                      AnomalyCheck(recorder, ndcg_series,
                                   direction="drop", **kwargs))

    def watch_transfers(self, ledger, name: str = "transfers") -> None:
        """Register the steady-state transfer/retrace gate
        (``obs.transfers.TransferSteadyCheck``) over a
        ``TransferLedger``: OK through warmup, DEGRADED the moment any
        post-``mark_steady()`` library rebuild/reload or implicit
        host↔device transfer lands."""
        from large_scale_recommendation_tpu_torch.obs.transfers import (
            TransferSteadyCheck,
        )

        self.register(name, TransferSteadyCheck(ledger))

    # -- evaluation ----------------------------------------------------------

    def run(self) -> dict:
        """Evaluate every check and return the aggregate report:
        ``{"status", "time", "checks": {name: {"status", "detail"}}}``.
        A check that raises contributes ``CRITICAL`` with the error in
        its detail rather than taking the monitor down with it."""
        with self._lock:
            checks = list(self._checks.items())
        results: dict[str, dict] = {}
        worst = OK
        for name, check in checks:
            try:
                res = check()
                if not isinstance(res, CheckResult):
                    res = CheckResult(
                        CRITICAL,
                        {"error": f"check returned {type(res).__name__}, "
                                  "not CheckResult"})
            except Exception as e:  # a broken probe IS an incident
                res = CheckResult(CRITICAL, {"error": repr(e)})
            results[name] = {"status": res.status, "detail": res.detail}
            if SEVERITY[res.status] > SEVERITY[worst]:
                worst = res.status
            self._obs.gauge("health_check_status",
                            check=name).set(SEVERITY[res.status])
        self._obs.gauge("health_status").set(SEVERITY[worst])
        report = {"status": worst, "time": time.time(), "checks": results}
        with self._lock:
            prev, self._last_status = self._last_status, worst
        # an unobserved monitor counts as OK: a FIRST evaluation that is
        # already DEGRADED/CRITICAL (monitor started after the incident
        # began) is exactly the transition the black box must capture
        prev = OK if prev is None else prev
        if worst != prev:
            self._on_transition(prev, worst, report)
        return report

    def _on_transition(self, prev: str, worst: str, report: dict) -> None:
        """Aggregate status changed: journal the transition, and on an
        entry into CRITICAL freeze a postmortem bundle (the flight
        recorder's auto-trigger). Lazy module lookups: transitions are
        cold, and lazy resolution makes construction order between
        monitor, journal and recorder irrelevant."""
        from large_scale_recommendation_tpu_torch.obs.events import (
            get_events,
        )
        from large_scale_recommendation_tpu_torch.obs.recorder import (
            get_recorder,
        )

        failing = {n: r["status"] for n, r in report["checks"].items()
                   if r["status"] != OK}
        journal = get_events()
        if journal is not None:
            severity = {OK: "info", DEGRADED: "warning",
                        CRITICAL: "critical"}[worst]
            journal.emit("health.transition", severity=severity,
                         from_status=prev, to_status=worst,
                         failing_checks=failing)
        if worst == CRITICAL:
            recorder = get_recorder()
            if recorder is not None:
                recorder.maybe_dump("health_critical",
                                    detail={"from_status": prev,
                                            "failing_checks": failing},
                                    health_report=report)


# --------------------------------------------------------------------------
# SLO tracking (serving)
# --------------------------------------------------------------------------


class _WindowReservoir:
    """One sliding violation window: a bounded deque of booleans plus a
    running violation count. The whole SLO plane is built from these —
    ``SLOTracker`` holds one *primary* reservoir (the pre-multi-window
    behaviour, bit-compatible) plus any number of named extras
    (fast/slow SRE pairs). Not thread-safe on its own: the owner
    serializes ``push`` under its lock."""

    __slots__ = ("size", "violations", "_win")

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"window must be >= 1, got {size}")
        self.size = int(size)
        self.violations = 0  # violations inside the window
        self._win: deque[bool] = deque()

    def push(self, viol: bool) -> None:
        if len(self._win) == self.size:
            self.violations -= self._win.popleft()
        self._win.append(viol)
        self.violations += viol

    @property
    def fill(self) -> int:
        return len(self._win)

    def stats(self, objective: float) -> tuple[float, float, float]:
        """(attainment, burn_rate, error_budget_remaining) over the
        current fill; the empty reservoir reads as a full budget."""
        n = len(self._win)
        if n == 0:
            return 1.0, 0.0, 1.0
        frac = self.violations / n
        burn = frac / (1.0 - objective)
        return 1.0 - frac, burn, max(0.0, 1.0 - burn)


class SLOTracker:
    """Sliding-window latency-target attainment and error-budget burn.

    ``record(latency_s)`` per served unit (``ServingEngine`` records
    each flush wall — already measured on that path, so attaching a
    tracker adds no clock reads). Over the last ``window`` samples:

    - ``attainment``   — fraction with latency ≤ ``target_s``
    - ``burn_rate``    — observed violation fraction / allowed fraction
      (``1 - objective``); 1.0 = burning exactly the budget, >1 = over
    - ``error_budget_remaining`` — ``max(0, 1 - burn_rate)``

    ``windows`` adds named secondary reservoirs on the same sample
    stream — the SRE fast/slow pair (a short window that catches a
    cliff in seconds, a long one that catches a slow leak) is
    ``windows={"fast": 64, "slow": 1024}``-style; ``burn_rates()``
    reads every pair at once and each extra publishes
    ``slo_burn_rate{slo=,window=}``. The primary window's math and
    gauges are untouched by extras. Gauges (``slo_attainment{slo=}``,
    ``slo_burn_rate{slo=}``, ``slo_error_budget_remaining{slo=}``) and
    counters (``slo_requests_total`` / ``slo_violations_total``) publish
    on every record — no-op singletons under the null registry.
    """

    def __init__(self, target_s: float, objective: float = 0.99,
                 window: int = 512, name: str = "serving", registry=None,
                 windows: dict[str, int] | None = None):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.window = int(window)
        self.name = name
        self._lock = threading.Lock()
        self._primary = _WindowReservoir(window)
        self._extras: dict[str, _WindowReservoir] = {
            str(w): _WindowReservoir(n) for w, n in (windows or {}).items()}
        self.count = 0  # lifetime samples
        self.violations = 0  # lifetime violations
        obs = registry or get_registry()
        self._m_req = obs.counter("slo_requests_total", slo=name)
        self._m_viol = obs.counter("slo_violations_total", slo=name)
        self._m_att = obs.gauge("slo_attainment", slo=name)
        self._m_burn = obs.gauge("slo_burn_rate", slo=name)
        self._m_budget = obs.gauge("slo_error_budget_remaining", slo=name)
        self._m_extras = {
            w: obs.gauge("slo_burn_rate", slo=name, window=w)
            for w in self._extras}

    def record(self, latency_s: float) -> None:
        viol = not (latency_s <= self.target_s)  # NaN counts as violated
        extra_burns = {}
        with self._lock:
            self._primary.push(viol)
            for w, res in self._extras.items():
                res.push(viol)
                extra_burns[w] = res.stats(self.objective)[1]
            self.count += 1
            self.violations += viol
            att, burn, budget = self._primary.stats(self.objective)
        self._m_req.inc()
        if viol:
            self._m_viol.inc()
        self._m_att.set(att)
        self._m_burn.set(burn)
        self._m_budget.set(budget)
        for w, b in extra_burns.items():
            self._m_extras[w].set(b)

    @property
    def attainment(self) -> float:
        with self._lock:
            return self._primary.stats(self.objective)[0]

    @property
    def burn_rate(self) -> float:
        with self._lock:
            return self._primary.stats(self.objective)[1]

    @property
    def error_budget_remaining(self) -> float:
        with self._lock:
            return self._primary.stats(self.objective)[2]

    def burn_rates(self) -> dict[str, float]:
        """Every window's burn rate in one locked read: the primary
        under its configured size (key ``"primary"``) plus each named
        extra — the fast/slow pair a multi-window alert reads
        together."""
        with self._lock:
            rates = {"primary": self._primary.stats(self.objective)[1]}
            for w, res in self._extras.items():
                rates[w] = res.stats(self.objective)[1]
            return rates

    def snapshot(self) -> dict:
        with self._lock:
            att, burn, budget = self._primary.stats(self.objective)
            snap = {
                "name": self.name,
                "target_s": self.target_s,
                "objective": self.objective,
                "window": self.window,
                "window_fill": self._primary.fill,
                "count": self.count,
                "violations": self.violations,
                "attainment": att,
                "burn_rate": burn,
                "error_budget_remaining": budget,
            }
            if self._extras:
                snap["windows"] = {
                    w: {"size": res.size, "fill": res.fill,
                        "burn_rate": res.stats(self.objective)[1],
                        "error_budget_remaining":
                            res.stats(self.objective)[2]}
                    for w, res in self._extras.items()}
            return snap


class ServingHealthCheck:
    """SLO-backed serving health: within budget → OK; burning more than
    the budget (burn > 1) → DEGRADED; burning at ≥ ``critical_burn``
    times the budget → CRITICAL. An idle tracker (no samples) is OK —
    a not-yet-serving engine is not an incident — and CRITICAL is
    withheld until the window holds ``min_samples`` (default: the
    smallest fill at which ONE violation alone cannot reach
    ``critical_burn``, i.e. ``ceil(1 / ((1-objective) *
    critical_burn))``): without that guard the very first flush — the
    one paying the first-call costs — would flip a liveness-probed
    ``/healthz`` to 503 and restart-loop the process at warmup."""

    def __init__(self, slo: SLOTracker, critical_burn: float = 2.0,
                 min_samples: int | None = None):
        self.slo = slo
        self.critical_burn = float(critical_burn)
        if min_samples is None:
            # floor+1, not ceil: when 1/((1-obj)*burn) is exact (e.g.
            # objective 0.5, burn 2 → 1.0) ceil would admit a fill where
            # a single violation alone reaches critical_burn. Capped at
            # the window size — window_fill can never exceed it, and an
            # uncapped guard would leave the check "warming" forever
            # (CRITICAL permanently unreachable on a fully burned
            # budget).
            min_samples = min(
                math.floor(1.0 / ((1.0 - slo.objective)
                                  * self.critical_burn)) + 1,
                slo.window)
        self.min_samples = max(1, int(min_samples))

    def __call__(self) -> CheckResult:
        snap = self.slo.snapshot()
        if snap["count"] == 0:
            return ok(note="no samples yet", **snap)
        burn = snap["burn_rate"]
        warming = snap["window_fill"] < self.min_samples
        if burn >= self.critical_burn and not warming:
            return critical(**snap)
        if burn > 1.0:
            if warming:
                return degraded(note=f"window warming "
                                     f"({snap['window_fill']}/"
                                     f"{self.min_samples} samples)",
                                **snap)
            return degraded(**snap)
        return ok(**snap)


# --------------------------------------------------------------------------
# Training watchdog (divergence guard)
# --------------------------------------------------------------------------


class TrainingDivergedError(RuntimeError):
    """Raised by a tripped ``TrainingWatchdog`` under the ``halt`` and
    ``rollback`` policies. ``rolled_back`` records whether the last
    durable snapshot was restored before raising."""

    def __init__(self, reason: str, detail: dict | None = None,
                 rolled_back: bool = False):
        self.reason = reason
        self.detail = detail or {}
        self.rolled_back = rolled_back
        suffix = " (rolled back to last checkpoint)" if rolled_back else ""
        super().__init__(f"training diverged: {reason}{suffix} "
                         f"{self.detail}")


def _all_finite(*tables) -> bool:
    """One device-side reduction per table; a single bool crosses back."""
    for t in tables:
        if t is None or t.numel() == 0:
            continue
        if not bool(torch.isfinite(t).all()):
            return False
    return True


def _heal_non_finite_rows(table) -> int:
    """Re-initialize any non-finite active rows of a growable factor
    table from its id-deterministic initializer. ``restore_online_state``
    only covers ids the snapshot knew — an id first seen AFTER the
    snapshot keeps its live row, and a poisoned one can never heal by
    replay (NaN absorbs every update). Fresh per-id init is what a cold
    restart + replay would hand those ids. Returns #rows healed."""
    n = table.num_rows
    if n == 0:
        return 0
    bad = ~torch.isfinite(table.array[:n]).all(dim=1)
    rows = torch.nonzero(bad).squeeze(1)
    if rows.numel() == 0:
        return 0
    ids = table.id_array()[rows.cpu().numpy()]
    fresh = table.initializer(torch.as_tensor(ids, device=table.device))
    arr = table.array.clone()  # tables are never written in place
    arr[rows] = fresh.to(arr.dtype)
    table.array = arr
    return int(rows.numel())


class TrainingWatchdog:
    """Divergence guard for the training tiers.

    Hooks (every one gated by ``watchdog is not None`` at the call
    site — an unattached model does zero extra work):

    - ``after_batch(online, U, V, u_rows, i_rows)`` — called by
      ``OnlineMF.partial_fit`` AFTER the update applies and BEFORE the
      WAL offset is stamped, every ``check_every`` batches. Scans only
      the rows this batch touched (a NaN can only enter through them),
      so the cost is one small gather+reduction, not a table sweep.
      Tripping before the stamp is the point: the streaming driver
      checkpoints off the stamp, so a halted/rolled-back batch can
      never persist poisoned factors.
    - ``after_segment(U, V, label)`` — called by the batch trainers
      (``DSGD._train_segments``) at segment boundaries: full-table scan
      (segments are seconds, not milliseconds — the sweep is noise).
    - ``check_swap(U, V)`` — called by ``AdaptiveMF._install`` on the
      RETRAINED factors before they overwrite the live tables and
      refresh the serving engines: a diverged retrain aborts before the
      catalog swap.
    - ``observe_loss(loss)`` — feed an RMSE-style signal (the
      ``rmse_curve`` shape the bench tracks); a non-finite loss trips
      immediately; a full ``loss_window`` of strictly rising values
      whose total relative rise is ≥ ``loss_rise_tol`` trips
      (divergence); a full non-decreasing window that doesn't meet the
      trip bar marks the watchdog DEGRADED (trending).

    Policies on trip: ``"observe"`` (mark tripped; ``check()`` reports
    CRITICAL; training continues), ``"halt"`` (raise
    ``TrainingDivergedError``), ``"rollback"`` (restore the last
    durable online snapshot — factors AND consumed WAL offsets, via
    ``restore_online_state`` — then raise with ``rolled_back=True``;
    requires ``manager`` and an online-model hook — segment/loss trips
    without a bound model fall back to halt semantics).

    ``check()`` is the ``HealthMonitor`` probe: CRITICAL when tripped,
    DEGRADED when trending, OK otherwise. ``reset()`` rearms.
    """

    POLICIES = ("observe", "halt", "rollback")

    def __init__(self, policy: str = "halt", manager=None,
                 check_every: int = 1, loss_window: int = 5,
                 loss_rise_tol: float = 0.05, registry=None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.policy = policy
        self.manager = manager
        self.check_every = int(check_every)
        self.loss_window = int(loss_window)
        self.loss_rise_tol = float(loss_rise_tol)
        self.tripped = False
        self.reason: str | None = None
        self.detail: dict = {}
        self.warning = False
        self.trips = 0
        self.rollbacks = 0
        self._batches_seen = 0
        self._losses: deque[float] = deque(maxlen=max(2, self.loss_window))
        self._model = None  # last online model seen (rollback target)
        self._lock = threading.Lock()
        # path of the postmortem bundle the last trip froze (None when no
        # flight recorder with a bundle_dir was installed, or its write
        # failed: the recorder's last_dump_error says why)
        self.last_bundle: str | None = None
        obs = registry or get_registry()
        self._obs = obs
        self._m_state = obs.gauge("watchdog_state")

    # -- hooks ---------------------------------------------------------------

    @staticmethod
    def _rows_finite(table_arr, rows) -> bool:
        # the rows as they are: torch compiles nothing per shape, so the
        # JAX watchdog's pow2 padding (which bounds XLA recompiles) has
        # nothing to do here
        if len(rows) == 0:
            return True
        idx = torch.as_tensor(np.asarray(rows, np.int64),
                              device=table_arr.device)
        return bool(torch.isfinite(table_arr[idx]).all())

    def after_batch(self, online, U, V, u_rows, i_rows) -> None:
        self._model = online
        self._batches_seen += 1
        if self._batches_seen % self.check_every:
            return
        if not (self._rows_finite(U, u_rows)
                and self._rows_finite(V, i_rows)):
            self._trip("non_finite_factors",
                       {"step": getattr(online, "step", None),
                        "rows_checked": int(len(u_rows)) + int(len(i_rows))})

    def after_segment(self, U, V, label: str = "train") -> None:
        if not _all_finite(U, V):
            self._trip("non_finite_factors", {"where": label})

    def check_swap(self, U, V) -> None:
        if not _all_finite(U, V):
            self._trip("non_finite_retrain", {"where": "catalog_swap"})

    def observe_loss(self, loss: float) -> None:
        loss = float(loss)
        if not math.isfinite(loss):
            self._trip("non_finite_loss", {"loss": loss})
            return
        # window mutation + read under the lock: check() (a /healthz
        # handler thread) snapshots _losses concurrently, and an
        # unlocked deque append mid-iteration would raise there — which
        # HealthMonitor would then report as a spurious CRITICAL.
        # _trip is called OUTSIDE the lock (it takes it itself).
        with self._lock:
            self._losses.append(loss)
            if len(self._losses) < max(2, self.loss_window):
                return
            vals = list(self._losses)
        deltas = [b - a for a, b in zip(vals, vals[1:])]
        rising = all(d > 0 for d in deltas)
        trending = all(d >= 0 for d in deltas)
        rise = (vals[-1] - vals[0]) / abs(vals[0]) if vals[0] else math.inf
        if rising and rise >= self.loss_rise_tol:
            self._trip("loss_divergence",
                       {"window": vals, "rise": round(rise, 6)})
        else:
            with self._lock:
                self.warning = trending
                tripped = self.tripped
            if not tripped:  # mirror the full 0/1/2 severity scale
                self._m_state.set(1 if trending else 0)

    # -- trip machinery ------------------------------------------------------

    def _trip(self, reason: str, detail: dict) -> None:
        with self._lock:
            first = not self.tripped
            self.tripped = True
            self.reason = reason
            self.detail = detail
            self.trips += 1
        if first:  # publish once per incident, not per re-detection
            self._obs.counter("watchdog_trips_total", reason=reason).inc()
            # the flight-recorder half of the incident: journal the
            # finding and freeze a postmortem bundle BEFORE any policy
            # runs — the bundle must hold the lead-up (and, under
            # rollback, the pre-restore state), not the aftermath.
            # Lazy lookups: trips are cold, and this way the recorder
            # may be installed before or after the watchdog.
            from large_scale_recommendation_tpu_torch.obs.events import (
                get_events,
            )
            from large_scale_recommendation_tpu_torch.obs.recorder import (
                get_recorder,
            )

            journal = get_events()
            if journal is not None:
                journal.emit("watchdog.trip", severity="critical",
                             reason=reason, policy=self.policy,
                             context=detail)
            recorder = get_recorder()
            if recorder is not None:
                self.last_bundle = recorder.maybe_dump(
                    "watchdog_trip",
                    detail={"reason": reason, "policy": self.policy,
                            **detail})
        self._m_state.set(2)
        if self.policy == "observe":
            return
        rolled_back = False
        if (self.policy == "rollback" and self.manager is not None
                and self._model is not None
                and self.manager.latest_step() is not None):
            from large_scale_recommendation_tpu_torch.utils.checkpoint import (
                restore_online_state,
            )

            restore_online_state(self.manager, self._model)
            # ids first seen after the snapshot aren't in it — their
            # rows survived the restore and may carry the poison (which
            # a replayed tail can never heal: NaN absorbs every update).
            # Re-init them per-id, the cold-restart semantics.
            healed = (_heal_non_finite_rows(self._model.users)
                      + _heal_non_finite_rows(self._model.items))
            detail["rows_reinitialized"] = healed
            with self._lock:
                self.rollbacks += 1
                self.detail = detail
            rolled_back = True
            self._obs.counter("watchdog_rollbacks_total").inc()
            from large_scale_recommendation_tpu_torch.obs.events import (
                get_events,
            )

            journal = get_events()
            if journal is not None:
                journal.emit("watchdog.rollback", severity="error",
                             reason=reason,
                             rows_reinitialized=healed,
                             restored_step=self.manager.latest_step())
        raise TrainingDivergedError(reason, detail, rolled_back=rolled_back)

    def reset(self) -> None:
        """Rearm after an incident was handled (state restored or the
        poisoned source quarantined). Loss history is cleared too — the
        pre-incident trajectory says nothing about the restored state."""
        with self._lock:
            self.tripped = False
            self.reason = None
            self.detail = {}
            self.warning = False
            self._losses.clear()
        self._m_state.set(0)

    # -- health probe --------------------------------------------------------

    def check(self) -> CheckResult:
        with self._lock:
            if self.tripped:
                return critical(reason=self.reason, trips=self.trips,
                                rollbacks=self.rollbacks, **self.detail)
            if self.warning:
                return degraded(reason="loss_trending_up",
                                window=list(self._losses))
            return ok(batches_seen=self._batches_seen, trips=self.trips)


# --------------------------------------------------------------------------
# Built-in checks: stream + checkpoint
# --------------------------------------------------------------------------


class StreamHealthCheck:
    """Ingest-tier health from ``StreamingDriver.telemetry()``: lag in
    records against the log head (DEGRADED at ``degraded_lag``,
    CRITICAL at ``critical_lag``) and recent dead-letter growth (any
    growth → DEGRADED: poison records are arriving faster than anyone
    quarantines them). The growth signal is STICKY for
    ``growth_window_s`` after the last observed increase — ``/healthz``
    evaluates checks per request, and without the window whichever
    client polled first (a 1 s load-balancer probe, say) would consume
    the DEGRADED verdict and every later observer would see OK. Each
    evaluation also refreshes the driver's lag/queue gauges — a
    health-polled driver needs no separate telemetry cadence."""

    def __init__(self, driver, degraded_lag: int = 10_000,
                 critical_lag: int | None = None,
                 growth_window_s: float = 300.0):
        self.driver = driver
        self.degraded_lag = int(degraded_lag)
        self.critical_lag = (int(critical_lag)
                             if critical_lag is not None else None)
        self.growth_window_s = float(growth_window_s)
        self._lock = threading.Lock()  # /healthz evaluates per request,
        # possibly from several handler threads at once
        self._last_dead = None
        self._last_growth_t = None
        self._recent_growth = 0

    @staticmethod
    def _dead_letters(tel: dict) -> int:
        q = tel.get("queue", {}) or {}
        return int(q.get("dead_letter_records", 0) or 0) \
            + int(q.get("poison_records", 0) or 0)

    def __call__(self) -> CheckResult:
        tel = self.driver.telemetry()
        now = time.time()
        lag = int(tel.get("lag_records", 0))
        dead = self._dead_letters(tel)
        with self._lock:
            if self._last_dead is not None and dead > self._last_dead:
                self._last_growth_t = now
                self._recent_growth += dead - self._last_dead
            # only advance the baseline, never regress it: two scrapes
            # racing with interleaved telemetry reads must not
            # double-count the same growth
            if self._last_dead is None or dead > self._last_dead:
                self._last_dead = dead
            growing = (self._last_growth_t is not None
                       and now - self._last_growth_t
                       < self.growth_window_s)
            if not growing:
                self._recent_growth = 0
            recent = self._recent_growth
        detail = {"lag_records": lag, "dead_letter_records": dead,
                  "dead_letter_growth": recent,
                  "consumed_offset": tel.get("consumed_offset"),
                  "log_end_offset": tel.get("log_end_offset")}
        if self.critical_lag is not None and lag >= self.critical_lag:
            return critical(**detail)
        if lag >= self.degraded_lag or growing:
            return degraded(**detail)
        return ok(**detail)


class CheckpointStalenessCheck:
    """Durable-snapshot freshness: DEGRADED when the newest checkpoint
    is older than ``degraded_after_s`` (or none exists yet), CRITICAL
    past ``critical_after_s``. Age is the snapshot file's mtime — works
    for both the plain and sharded managers (falls back to the newest
    file in the checkpoint directory when the canonical
    ``ckpt_<step>.npz`` name is absent)."""

    def __init__(self, manager, degraded_after_s: float,
                 critical_after_s: float | None = None):
        self.manager = manager
        self.degraded_after_s = float(degraded_after_s)
        self.critical_after_s = (float(critical_after_s)
                                 if critical_after_s is not None else None)

    def _latest_mtime(self, step: int) -> float | None:
        d = self.manager.directory
        canonical = os.path.join(d, f"ckpt_{step}.npz")
        if os.path.exists(canonical):
            return os.path.getmtime(canonical)
        mtimes = [os.path.getmtime(os.path.join(d, n))
                  for n in os.listdir(d) if n.startswith(f"ckpt_{step}.")]
        return max(mtimes) if mtimes else None

    def __call__(self) -> CheckResult:
        step = self.manager.latest_step()
        if step is None:
            return degraded(note="no checkpoint yet",
                            directory=self.manager.directory)
        mtime = self._latest_mtime(step)
        if mtime is None:
            return degraded(note="checkpoint listed but file missing",
                            step=step)
        age = time.time() - mtime
        detail = {"step": step, "age_s": round(age, 3)}
        if self.critical_after_s is not None and age >= self.critical_after_s:
            return critical(**detail)
        if age >= self.degraded_after_s:
            return degraded(**detail)
        return ok(**detail)


# --------------------------------------------------------------------------
# Periodic export cadence
# --------------------------------------------------------------------------


class PeriodicTask:
    """Run ``fn()`` every ``interval_s`` on a daemon thread until
    ``stop()``. Errors are counted and the last one kept — a flaky
    telemetry pass must not kill the cadence (or the process). The
    first run happens one interval after ``start()``."""

    def __init__(self, fn: Callable[[], Any], interval_s: float,
                 name: str = "periodic"):
        self.fn = fn
        self.interval_s = float(interval_s)
        self.name = name
        self.runs = 0
        self.errors = 0
        self.last_error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "PeriodicTask":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.fn()
                self.runs += 1
            except Exception as e:
                self.errors += 1
                self.last_error = e

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


def ensure_periodic(task: PeriodicTask | None, fn: Callable[[], Any],
                    interval_s: float, name: str) -> PeriodicTask:
    """Idempotent start-or-reuse for a ``PeriodicTask`` — ONE copy of
    the cadence/error-counting wiring shared by every timed exporter
    (the introspector's sampler, the online evaluator's cadence). A live
    task is returned as-is; a missing or stopped one
    is replaced by a freshly started task."""
    if task is not None and task.running:
        return task
    return PeriodicTask(fn, interval_s, name=name).start()
