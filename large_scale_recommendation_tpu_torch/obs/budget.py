"""ROLLOUT observability plane: error budgets, per-version attribution
and canary verdicts (counterpart of
``large_scale_recommendation_tpu.obs.budget``).

- **multi-window error budgets** — the plane's service-level
  ``SLOTracker`` carries the SRE fast/slow window pair
  (``slo_burn_rate{window="fast"|"slow"}``): the fast window catches a
  cliff within a flush or two, the slow window the leak a fast window
  forgives, and ``error_budget_remaining`` is what scale decisions read.
- **per-catalog-version attribution** — every served request's outcome
  (latency, shed / admitted, degraded, the ``OnlineEvaluator``'s shadow
  scores, staleness extras) lands in the cohort of the ``catalog_version``
  that served it: the engine's own version token
  (``parallel.serving.catalog_version``), stamped on every swap. A
  regression names the deploy that caused it, not the minute it happened.
- **``CanaryVerdictEngine``** — compares the canary version's cohort with
  the incumbent's under minimum-sample and effect-size thresholds and
  emits PROMOTE / HOLD / ROLLBACK verdicts, stamped into lineage
  (``LineageJournal.record_verdict``). An un-acted-on ROLLBACK flips
  ``/healthz`` DEGRADED through ``RolloutCheck``
  (``HealthMonitor.watch_rollout``) until ``mark_rolled_back`` lands.

``/budgetz`` (``obs.server``) serves the plane; ``obs.fleet`` merges
cohorts by version across processes; postmortem bundles freeze it
(``budget.json``). The arithmetic is host Python over floats the engine
measured, identical to the JAX package's. Zero-cost when unused: the
module default is ``None`` (``get_budget``), every noting site is one ``is
not None`` test, ``serve_scope`` hands back the shared ``_NULL_CONTEXT``,
and ``obs.enable_budget()`` installs one.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.health import SLOTracker, _WindowReservoir
from large_scale_recommendation_tpu_torch.obs.lineage import get_lineage
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.transfers import _NULL_CONTEXT

PROMOTE = "PROMOTE"
HOLD = "HOLD"
ROLLBACK = "ROLLBACK"

# eval metrics where DOWN is better; everything else (ndcg, hr,
# coverage) reads higher-better
_LOWER_BETTER_EVAL = ("rmse", "loss", "staleness", "lag")


def _lower_better(key: str) -> bool:
    return any(tok in key for tok in _LOWER_BETTER_EVAL)


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


class _Cohort:
    """One catalog version's outcome ledger: counts, a bounded latency
    reservoir for tail quantiles, fast/slow violation windows, the
    latest shadow-eval scores, and free-form extras (staleness,
    implicit-transfer / library-reload counts). Owner serializes under the
    budget's lock."""

    __slots__ = ("version", "served", "violations", "shed", "degraded",
                 "lat_sum", "lats", "fast", "slow", "evals", "extras",
                 "first_t", "last_t")

    def __init__(self, version: int, fast_window: int, slow_window: int,
                 lat_reservoir: int, t: float):
        self.version = int(version)
        self.served = 0
        self.violations = 0
        self.shed = 0
        self.degraded = 0
        self.lat_sum = 0.0
        self.lats: deque[float] = deque(maxlen=int(lat_reservoir))
        self.fast = _WindowReservoir(fast_window)
        self.slow = _WindowReservoir(slow_window)
        self.evals: dict = {}
        self.extras: dict = {}
        self.first_t = t
        self.last_t = t

    def snapshot(self, objective: float) -> dict:
        lats = sorted(self.lats)
        offered = self.served + self.shed
        _, fast_burn, _ = self.fast.stats(objective)
        att, slow_burn, budget = self.slow.stats(objective)
        return {
            "version": self.version,
            "served": self.served,
            "shed": self.shed,
            "violations": self.violations,
            "degraded": self.degraded,
            "shed_frac": (self.shed / offered) if offered else 0.0,
            "degraded_frac": ((self.degraded / self.served)
                              if self.served else 0.0),
            "mean_ms": ((self.lat_sum / self.served) * 1e3
                        if self.served else 0.0),
            "p50_ms": _quantile(lats, 0.50) * 1e3,
            "p99_ms": _quantile(lats, 0.99) * 1e3,
            "attainment": att,
            "burn_rate_fast": fast_burn,
            "burn_rate_slow": slow_burn,
            "error_budget_remaining": budget,
            "evals": dict(self.evals),
            "extras": dict(self.extras),
            "first_t": self.first_t,
            "last_t": self.last_t,
        }


class RolloutBudget:
    """The ROLLOUT plane object: a service-level multi-window
    ``SLOTracker`` plus per-``catalog_version`` outcome cohorts and an
    owned ``CanaryVerdictEngine`` (``self.verdicts``).

    Noting sites (engine flush, admission shed, evaluator shadow runs)
    call ``note_result``/``note_shed``/``note_eval``/``note_extra``
    keyed by the version that served; all are cheap bounded-structure
    updates under one lock, never on a scrape's critical path.
    ``max_versions`` bounds the cohort table (oldest versions evict —
    the fleet only ever reasons about a handful of live builds).
    """

    def __init__(self, target_s: float, objective: float = 0.99,
                 fast_window: int = 64, slow_window: int = 1024,
                 lat_reservoir: int = 512, max_versions: int = 64,
                 name: str = "rollout", registry=None, **verdict_kwargs):
        if max_versions < 1:
            raise ValueError(
                f"max_versions must be >= 1, got {max_versions}")
        if fast_window > slow_window:
            raise ValueError(
                f"fast_window ({fast_window}) must be <= slow_window "
                f"({slow_window}) — the pair is a fast cliff-catcher "
                "inside a slow leak-catcher")
        self.name = name
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.lat_reservoir = int(lat_reservoir)
        self.max_versions = int(max_versions)
        obs = registry or get_registry()
        # the service-level budget: primary window = slow (the budget
        # you plan against), fast/slow extras published as
        # slo_burn_rate{slo=name, window=}
        self.slo = SLOTracker(
            target_s, objective=objective, window=slow_window, name=name,
            registry=obs,
            windows={"fast": fast_window, "slow": slow_window})
        self._lock = threading.Lock()
        self._cohorts: OrderedDict[int, _Cohort] = OrderedDict()
        self.evicted = 0
        self._m_served = obs.counter("rollout_served_total")
        self._m_shed = obs.counter("rollout_shed_total")
        self._m_versions = obs.gauge("rollout_versions")
        self.verdicts = CanaryVerdictEngine(self, registry=obs,
                                            **verdict_kwargs)

    @property
    def target_s(self) -> float:
        return self.slo.target_s

    @property
    def objective(self) -> float:
        return self.slo.objective

    def _cohort_locked(self, version: int, t: float) -> _Cohort:
        c = self._cohorts.get(int(version))
        if c is None:
            c = _Cohort(version, self.fast_window, self.slow_window,
                        self.lat_reservoir, t)
            self._cohorts[int(version)] = c
            while len(self._cohorts) > self.max_versions:
                self._cohorts.popitem(last=False)
                self.evicted += 1
        return c

    # -- noting sites --------------------------------------------------------

    def note_result(self, version: int, latency_s: float, *,
                    degraded: bool = False, t: float | None = None) -> None:
        """One served request's outcome, attributed to ``version``."""
        now = time.time() if t is None else float(t)
        viol = not (latency_s <= self.slo.target_s)  # NaN → violated
        with self._lock:
            c = self._cohort_locked(version, now)
            c.served += 1
            c.violations += viol
            c.degraded += bool(degraded)
            c.lat_sum += latency_s
            c.lats.append(latency_s)
            c.fast.push(viol)
            c.slow.push(viol)
            c.last_t = now
            n_versions = len(self._cohorts)
        self.slo.record(latency_s)
        self._m_served.inc()
        self._m_versions.set(n_versions)

    def note_results(self, version: int, latencies, *,
                     degraded: int = 0) -> None:
        """A flush's worth of outcomes in one call — the engine seam.
        ``degraded`` marks how many of them served the degraded
        (widened-deadline) path."""
        left = int(degraded)
        for lat in latencies:
            self.note_result(version, float(lat), degraded=left > 0)
            left -= 1

    def note_shed(self, version: int, n: int = 1) -> None:
        """``n`` requests shed by admission while ``version`` served."""
        now = time.time()
        with self._lock:
            c = self._cohort_locked(version, now)
            c.shed += int(n)
            c.last_t = now
        self._m_shed.inc(int(n))

    def note_eval(self, version: int, metrics: dict) -> None:
        """The ``OnlineEvaluator``'s shadow scores for the build that
        served them — merged, latest-wins per key. Only finite scalars
        land (the evaluator snapshot carries counts too)."""
        now = time.time()
        clean = {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float)) and v == v}
        with self._lock:
            c = self._cohort_locked(version, now)
            c.evals.update(clean)
            c.last_t = now

    def note_extra(self, version: int, **kv) -> None:
        """Free-form cohort annotations the verdict surfaces alongside
        the comparison: staleness_s, implicit_transfers, reloads."""
        now = time.time()
        with self._lock:
            c = self._cohort_locked(version, now)
            c.extras.update(kv)
            c.last_t = now

    def serve_scope(self, version: int):
        """Context manager timing one request into ``version``'s
        cohort — for callers that don't already measure the wall."""
        return _ServeScope(self, version)

    # -- reads ---------------------------------------------------------------

    def cohort(self, version: int) -> dict | None:
        """One version's cohort snapshot, or None (never served /
        evicted)."""
        with self._lock:
            c = self._cohorts.get(int(version))
            return None if c is None else c.snapshot(self.slo.objective)

    def versions(self) -> list[int]:
        with self._lock:
            return list(self._cohorts)

    def snapshot(self) -> dict:
        """The ``/budgetz`` body: service-level SLO (with the
        fast/slow window pair), per-version cohorts (string keys — the
        fleet merge joins on them), and the verdict state."""
        with self._lock:
            cohorts = {str(v): c.snapshot(self.slo.objective)
                       for v, c in self._cohorts.items()}
            evicted = self.evicted
        return {
            "time": time.time(),
            "name": self.name,
            "target_s": self.slo.target_s,
            "objective": self.slo.objective,
            "fast_window": self.fast_window,
            "slow_window": self.slow_window,
            "slo": self.slo.snapshot(),
            "burn_rates": self.slo.burn_rates(),
            "cohorts": cohorts,
            "evicted": evicted,
            "verdicts": self.verdicts.snapshot(),
        }

    def reset(self) -> None:
        with self._lock:
            self._cohorts.clear()
            self.evicted = 0
        self.verdicts.reset()


class _ServeScope:
    """Times one request and notes it into the cohort on exit."""

    __slots__ = ("_budget", "_version", "_t0")

    def __init__(self, budget: RolloutBudget, version: int):
        self._budget = budget
        self._version = version

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._budget.note_result(self._version,
                                 time.perf_counter() - self._t0)
        return False


class CanaryVerdictEngine:
    """PROMOTE/HOLD/ROLLBACK verdicts from cohort-vs-cohort comparison.

    ``evaluate(canary, incumbent)`` verdicts on effect sizes, never raw
    noise: below ``min_samples`` canary requests the verdict is HOLD
    (warming); a *hard* regression — fast-window burn ≥ ``burn_ratio``
    × the incumbent's (floored at ``burn_floor``), p99 ≥ ``p99_ratio``
    × the incumbent's, shed fraction ``shed_tol`` above, or any shared
    eval metric worse by ``eval_tol`` relative — is ROLLBACK; a *soft*
    signal (half the effect size) is HOLD while the sample budget
    lasts, and once ``sample_budget`` canary requests have been spent
    without exoneration the engine fails safe: ROLLBACK. Clean cohorts
    at ``min_samples`` PROMOTE.

    Every verdict is stamped into lineage
    (``LineageJournal.record_verdict``) and journaled
    (``rollout.verdict`` event). A ROLLBACK is *pending* until
    ``mark_rolled_back(version)`` — ``RolloutCheck`` holds ``/healthz``
    DEGRADED for exactly that interval.
    """

    def __init__(self, budget: RolloutBudget, *, min_samples: int = 32,
                 sample_budget: int = 512, burn_ratio: float = 2.0,
                 burn_floor: float = 1.0, p99_ratio: float = 2.0,
                 shed_tol: float = 0.10, eval_tol: float = 0.10,
                 history: int = 256, registry=None):
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        if sample_budget < min_samples:
            raise ValueError(
                f"sample_budget ({sample_budget}) must be >= min_samples "
                f"({min_samples})")
        self.budget = budget
        self.min_samples = int(min_samples)
        self.sample_budget = int(sample_budget)
        self.burn_ratio = float(burn_ratio)
        self.burn_floor = float(burn_floor)
        self.p99_ratio = float(p99_ratio)
        self.shed_tol = float(shed_tol)
        self.eval_tol = float(eval_tol)
        self._lock = threading.Lock()
        self._history: deque[dict] = deque(maxlen=int(history))
        self._pending: dict[int, dict] = {}
        self.evaluations = 0
        obs = registry or get_registry()
        self._m_verdicts = {
            v: obs.counter("rollout_verdicts_total", verdict=v)
            for v in (PROMOTE, HOLD, ROLLBACK)}
        self._m_pending = obs.gauge("rollout_pending_rollbacks")

    # -- comparison ----------------------------------------------------------

    def _signals(self, can: dict, inc: dict,
                 scale: float = 1.0) -> list[str]:
        """Regression signals at ``scale`` × the configured effect
        sizes (1.0 = hard/ROLLBACK thresholds, 0.5 = soft/HOLD). The
        ratio bars scale their margin ABOVE parity — at scale 0.5 a
        ratio of 2.0 bars at 1.5×, never at 1.0× (a canary exactly
        matching its incumbent must produce no signal)."""
        out = []
        burn_bar = (1.0 + scale * (self.burn_ratio - 1.0)) * max(
            inc["burn_rate_fast"], self.burn_floor)
        if can["burn_rate_fast"] >= burn_bar:
            out.append(f"burn_rate_fast {can['burn_rate_fast']:.2f} >= "
                       f"{burn_bar:.2f} (incumbent "
                       f"{inc['burn_rate_fast']:.2f})")
        if inc["p99_ms"] > 0.0:
            p99_bar = (1.0 + scale * (self.p99_ratio - 1.0)) * inc["p99_ms"]
            if can["p99_ms"] >= p99_bar:
                out.append(f"p99_ms {can['p99_ms']:.1f} >= "
                           f"{p99_bar:.1f} (incumbent "
                           f"{inc['p99_ms']:.1f})")
        if can["shed_frac"] - inc["shed_frac"] >= scale * self.shed_tol:
            out.append(f"shed_frac {can['shed_frac']:.3f} vs incumbent "
                       f"{inc['shed_frac']:.3f}")
        tol = scale * self.eval_tol
        for key in sorted(set(can["evals"]) & set(inc["evals"])):
            cv, iv = can["evals"][key], inc["evals"][key]
            base = max(abs(iv), 1e-9)
            worse = ((cv - iv) / base if _lower_better(key)
                     else (iv - cv) / base)
            if worse > tol:
                out.append(f"eval {key} {cv:.4f} vs incumbent {iv:.4f} "
                           f"({worse:+.1%})")
        return out

    def evaluate(self, canary_version: int,
                 incumbent_version: int) -> dict:
        """Compare the canary cohort against the incumbent's and emit
        one verdict record (also returned):
        ``{"verdict", "reason", "canary_version", "incumbent_version",
        "canary", "incumbent", "time"}``."""
        can = self.budget.cohort(canary_version)
        inc = self.budget.cohort(incumbent_version)
        n = 0 if can is None else can["served"]
        if can is None or n < self.min_samples:
            verdict, reason = HOLD, (
                f"canary cohort warming ({n}/{self.min_samples} samples)")
        elif inc is None:
            verdict, reason = HOLD, (
                f"no incumbent cohort for version {incumbent_version}")
        else:
            hard = self._signals(can, inc, scale=1.0)
            if hard:
                verdict, reason = ROLLBACK, "; ".join(hard)
            else:
                soft = self._signals(can, inc, scale=0.5)
                if soft and n >= self.sample_budget:
                    # the sample budget is spent and the canary never
                    # exonerated itself — fail safe
                    verdict = ROLLBACK
                    reason = (f"sample budget exhausted ({n}/"
                              f"{self.sample_budget}) with unresolved "
                              "signals: " + "; ".join(soft))
                elif soft:
                    verdict, reason = HOLD, "; ".join(soft)
                else:
                    verdict, reason = PROMOTE, (
                        f"clean at {n} samples vs incumbent")
        record = {"verdict": verdict, "reason": reason,
                  "canary_version": int(canary_version),
                  "incumbent_version": int(incumbent_version),
                  "canary": can, "incumbent": inc, "time": time.time()}
        with self._lock:
            self.evaluations += 1
            self._history.append(record)
            if verdict == ROLLBACK:
                self._pending[int(canary_version)] = record
            elif verdict == PROMOTE:
                # a later clean verdict exonerates a pending rollback
                self._pending.pop(int(canary_version), None)
            n_pending = len(self._pending)
        self._m_verdicts[verdict].inc()
        self._m_pending.set(n_pending)
        lin = get_lineage()
        if lin is not None:
            lin.record_verdict(canary_version, verdict, reason=reason)
        journal = get_events()
        if journal is not None:
            journal.emit(
                "rollout.verdict",
                severity="error" if verdict == ROLLBACK else "info",
                verdict=verdict, reason=reason,
                canary_version=int(canary_version),
                incumbent_version=int(incumbent_version))
        return record

    # -- the pending-rollback state machine ----------------------------------

    def mark_rolled_back(self, version: int) -> bool:
        """The operator (or the fleet's auto-rollback) acted on the
        ROLLBACK: clear the pending state and stamp the act into
        lineage. Returns whether the version had a pending verdict."""
        with self._lock:
            record = self._pending.pop(int(version), None)
            n_pending = len(self._pending)
        self._m_pending.set(n_pending)
        lin = get_lineage()
        if lin is not None:
            lin.record_verdict(version, ROLLBACK, acted=True)
        journal = get_events()
        if journal is not None:
            journal.emit("rollout.rolled_back", severity="info",
                         version=int(version),
                         was_pending=record is not None)
        return record is not None

    def pending(self) -> dict[int, dict]:
        with self._lock:
            return dict(self._pending)

    def last_verdict(self) -> dict | None:
        with self._lock:
            return self._history[-1] if self._history else None

    def snapshot(self, limit: int = 20) -> dict:
        with self._lock:
            hist = list(self._history)[-limit:]
            pending = {str(v): {"reason": r["reason"], "time": r["time"]}
                       for v, r in self._pending.items()}
            return {
                "evaluations": self.evaluations,
                "pending_rollbacks": pending,
                "history": hist,
                "config": {
                    "min_samples": self.min_samples,
                    "sample_budget": self.sample_budget,
                    "burn_ratio": self.burn_ratio,
                    "burn_floor": self.burn_floor,
                    "p99_ratio": self.p99_ratio,
                    "shed_tol": self.shed_tol,
                    "eval_tol": self.eval_tol,
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._history.clear()
            self._pending.clear()
            self.evaluations = 0
        self._m_pending.set(0)


class RolloutCheck:
    """``HealthMonitor`` gate over the verdict engine: OK while no
    ROLLBACK sits un-acted-on, DEGRADED the moment one does — the
    rollout plane's equivalent of ``TransferSteadyCheck``. (DEGRADED,
    not CRITICAL: the *incumbent* is still serving; a liveness-probed
    ``/healthz`` must not restart-loop the healthy process.)"""

    def __init__(self, budget: RolloutBudget):
        self.budget = budget

    def __call__(self):
        from large_scale_recommendation_tpu_torch.obs.health import degraded, ok

        engine = self.budget.verdicts
        pending = engine.pending()
        if not pending:
            return ok(evaluations=engine.evaluations,
                      versions=len(self.budget.versions()))
        return degraded(
            note=f"{len(pending)} un-acted-on ROLLBACK verdict(s)",
            pending={str(v): r["reason"] for v, r in pending.items()},
            evaluations=engine.evaluations)


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by obs.enable_budget
# --------------------------------------------------------------------------

_BUDGET: RolloutBudget | None = None


def get_budget() -> RolloutBudget | None:
    """The installed rollout budget or ``None``. Noting components
    cache this at construction and gate every note on one ``is not
    None`` test — the same zero-cost discipline as ``get_transfers``."""
    return _BUDGET


def set_budget(budget: RolloutBudget | None) -> None:
    global _BUDGET
    _BUDGET = budget


def serve_scope(version: int):
    """Time one request into ``version``'s cohort; the shared no-op
    context (no clock reads, no allocation) when the plane is off."""
    b = get_budget()
    if b is None:
        return _NULL_CONTEXT
    return b.serve_scope(version)


def budgetz() -> dict:
    """The ``/budgetz`` endpoint body: the installed plane's snapshot,
    or the standard absent-plane note."""
    b = get_budget()
    if b is None:
        return {"note": "rollout budget not enabled (obs.enable_budget)",
                "cohorts": {}}
    return b.snapshot()
