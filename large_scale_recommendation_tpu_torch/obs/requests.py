"""REQUEST observability plane: per-request stage decomposition,
tail-based exemplar sampling and the ``/slowz`` surface (counterpart of
``large_scale_recommendation_tpu.obs.requests``).

- **stage ledgers** — the engine's flush seams (``serving.engine``,
  ``serving.retrieval.TwoStageRetriever.topk(mark=)``, the drain of
  ``ops.topk.run_pipelined_topk(on_drain=)``) mark a per-flush
  ``FlushLedger`` whose stages — ``batch_form``, ``gather``,
  ``score_stage1``, ``score_stage2``, ``topk_merge``, ``host_post`` —
  partition the flush wall exactly by construction: every ``mark`` is one
  clock read attributing the contiguous interval since the previous mark,
  ``finish`` assigns the residual to ``host_post`` (so the flush stages
  ``math.fsum`` to the flush wall), and each request's ``queue_wait`` is
  its measured wall minus the flush total (so the per-request stage sum
  ``math.fsum``s to the identical ``end - ts`` float the SLO tracker
  recorded: the clock read is shared, never re-read).
  ``request_stage_s{stage=}`` histograms and ``request_stage_frac{stage=}``
  window gauges name the dominant stage.
- **tail-based exemplars** — a bounded reservoir that always keeps
  SLO-violating, shed and degraded requests and otherwise the window's
  slowest N; each exemplar carries its stage ledger, ``catalog_version``,
  pow2 bucket, admission rung, queue depth at admit, and a span tree
  emitted into the tracer (``Tracer.complete_tree``) and the event journal.
- **surfaces** — ``/slowz`` (``obs.server``), merged worst-first across
  processes (``obs.fleet.FleetAggregator.requests``), frozen into
  postmortem bundles (``requests.json``), and ``RequestStageCheck``
  (``HealthMonitor.watch_requests``) flips DEGRADED when one stage's window
  fraction dominates while the SLO burns.

On the card the stage walls are host clocks, as the JAX package's are
under its asynchronous dispatch: ``gather``, ``score_stage1`` and
``score_stage2`` price the host's enqueue of the chunk's kernels, and the
card's time lands in ``topk_merge``, whose mark fires in the pipeline's
drain after the chunk's device→host copy event has been waited on. No mark
synchronizes the card (a ``torch.cuda.synchronize()`` per stage would
serialize the two-deep overlap ``ops.topk.run_pipelined_topk`` exists to
give), and no mark reads a tensor.

Zero-cost when unused: the module default is ``None`` (``get_requests``),
every noting seam is one ``is not None`` test, ``request_scope`` hands back
the shared ``_NULL_CONTEXT`` (no clock reads, no allocation), and
``obs.enable_requests()`` installs one.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer
from large_scale_recommendation_tpu_torch.obs.transfers import _NULL_CONTEXT

# the full stage taxonomy, in request-timeline order. queue_wait is
# per-request (submit stamp → flush start, by construction: wall minus
# flush total); the rest are flush-level intervals every request of
# the flush waited through. The exact mesh path has one fused score
# dispatch — it lands in score_stage1 and score_stage2 stays 0.
STAGES = ("queue_wait", "batch_form", "gather", "score_stage1",
          "score_stage2", "topk_merge", "host_post")

# exemplar classes, worst-first for display ordering ties
EXEMPLAR_KINDS = ("shed", "violating", "degraded", "slow")


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1) — the exemplar's
    bucket annotation, computed here so the plane needs no engine
    import."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _reconcile(stages: dict, residual_stage: str, total: float) -> None:
    """Nudge ``stages[residual_stage]`` until ``math.fsum(values)``
    EQUALS ``total`` — the exact-by-construction contract. fsum is
    correctly rounded, so one corrective pass almost always lands it;
    the loop bound is paranoia, not expectation."""
    for _ in range(4):
        s = math.fsum(stages.values())
        if s == total:
            return
        stages[residual_stage] += total - s


class FlushLedger:
    """One flush's stage accumulator. ``mark(stage, now)`` is ONE clock
    read attributing the contiguous interval since the previous mark
    (pass ``now`` to share a read the caller already paid — the
    engine's assembly histogram and the ledger's ``batch_form`` mark
    share one ``perf_counter()``); ``finish(end)`` assigns the residual
    to ``residual_stage`` so the stages fsum to ``end - t0`` exactly.
    Not thread-safe: one flush owns it."""

    __slots__ = ("t0", "_last", "stages")

    def __init__(self, t0: float):
        self.t0 = float(t0)
        self._last = self.t0
        self.stages: dict[str, float] = {}

    def mark(self, stage: str, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        self.stages[stage] = (self.stages.get(stage, 0.0)
                              + (now - self._last))
        self._last = now
        return now

    def finish(self, end: float,
               residual_stage: str = "host_post") -> float:
        """Close the ledger at ``end`` (the flush's already-measured
        end — share the read, don't re-read): the not-yet-attributed
        residual lands in ``residual_stage`` and the stage values then
        fsum to the returned flush total exactly."""
        total = end - self.t0
        acc = math.fsum(self.stages.values())
        self.stages[residual_stage] = (
            self.stages.get(residual_stage, 0.0) + (total - acc))
        _reconcile(self.stages, residual_stage, total)
        return total


class RequestTelemetry:
    """The REQUEST plane object: per-stage window accounting, a
    tail-based exemplar reservoir, and its own bounded wall window
    (fed the IDENTICAL ``end - ts`` floats the engine's ``SLOTracker``
    records, so the exemplar p99 and the SLO reservoir price the same
    stream).

    Noting sites (engine flush, admission shed) call
    ``note_flush``/``note_shed``; both are bounded-structure updates
    under one short lock, called OUTSIDE the engine lock, never on a
    scrape's critical path. ``max_exemplars`` bounds the always-keep
    class (violating/shed/degraded, newest win), ``slow_keep`` bounds
    the slowest-N reservoir for healthy windows.
    """

    def __init__(self, target_s: float, objective: float = 0.99,
                 window: int = 512, max_exemplars: int = 64,
                 slow_keep: int = 16, name: str = "serving",
                 registry=None):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if max_exemplars < 1:
            raise ValueError(
                f"max_exemplars must be >= 1, got {max_exemplars}")
        if slow_keep < 1:
            raise ValueError(f"slow_keep must be >= 1, got {slow_keep}")
        self.name = name
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.window = int(window)
        self.max_exemplars = int(max_exemplars)
        self.slow_keep = int(slow_keep)
        self._lock = threading.Lock()
        # one window deque of (wall, viol, stage-values-in-STAGES-order)
        # with running sums maintained on evict — fractions and p99 read
        # straight off it, no second structure to drift
        self._win: deque[tuple] = deque()
        self._win_viol = 0
        self._sum_wall = 0.0
        self._sum_stages = [0.0] * len(STAGES)
        # always-keep class: violating / shed / degraded, newest win
        self._kept: deque[dict] = deque(maxlen=self.max_exemplars)
        self.kept_evicted = 0
        # otherwise the window's slowest N: a capped min-list (tiny N —
        # linear replace-min beats heap bookkeeping at this size)
        self._slow: list[dict] = []
        self._seq = 0
        self.count = 0  # lifetime noted requests
        self.violations = 0  # lifetime violations
        self.shed = 0  # lifetime shed notes
        obs = registry or get_registry()
        self._m_stage = {s: obs.histogram("request_stage_s", stage=s)
                         for s in STAGES}
        self._m_frac = {s: obs.gauge("request_stage_frac", stage=s)
                        for s in STAGES}
        self._m_noted = obs.counter("request_noted_total")
        self._m_exemplars = {k: obs.counter("request_exemplars_total",
                                            kind=k)
                             for k in EXEMPLAR_KINDS}

    # -- ledger factory ------------------------------------------------------

    def ledger(self, t0: float) -> FlushLedger:
        """A fresh flush ledger anchored at the flush's already-read
        ``t0`` — the engine allocates one per flush only while the
        plane is installed."""
        return FlushLedger(t0)

    # -- noting sites --------------------------------------------------------

    def note_flush(self, ledger: FlushLedger, end: float, stamps, *,
                   version: int, degraded: bool = False, rows=None,
                   admission_level: str | None = None,
                   residual_stage: str = "host_post") -> None:
        """One flush's worth of requests: ``stamps`` are the submit
        perf-counter stamps in ticket order (so a request's index IS
        its queue depth at admit), ``end`` is the flush's measured end
        (``t0 + wall`` — the same float whose ``end - ts`` the SLO
        tracker recorded). ``rows`` optionally carries each request's
        served row count for the pow2-bucket annotation."""
        flush_total = ledger.finish(end, residual_stage)
        stages = ledger.stages
        keep: list[dict] = []
        with self._lock:
            for i, ts in enumerate(stamps):
                wall = end - ts
                viol = not (wall <= self.target_s)  # NaN → violated
                req = {"queue_wait": wall - flush_total}
                req.update(stages)
                _reconcile(req, "queue_wait", wall)
                vals = tuple(req.get(s, 0.0) for s in STAGES)
                if len(self._win) == self.window:
                    old_wall, old_viol, old_vals = self._win.popleft()
                    self._sum_wall -= old_wall
                    self._win_viol -= old_viol
                    for j, v in enumerate(old_vals):
                        self._sum_stages[j] -= v
                self._win.append((wall, viol, vals))
                self._sum_wall += wall
                self._win_viol += viol
                for j, v in enumerate(vals):
                    self._sum_stages[j] += v
                self.count += 1
                self.violations += viol
                n_rows = (int(rows[i]) if rows is not None
                          and i < len(rows) else None)
                ex = self._classify_locked(
                    wall, viol, degraded, req, ts,
                    version=version, queue_depth=i, rows=n_rows,
                    admission_level=admission_level)
                if ex is not None:
                    keep.append(ex)
            frac = ({} if self._sum_wall <= 0.0 else
                    {s: self._sum_stages[j] / self._sum_wall
                     for j, s in enumerate(STAGES)})
        # metric + trace/journal publishes outside the plane lock
        self._m_noted.inc(len(stamps))
        for i, ts in enumerate(stamps):
            wall = end - ts
            req = {"queue_wait": wall - flush_total}
            req.update(stages)
            for s in STAGES:
                self._m_stage[s].observe(req.get(s, 0.0))
        for s, f in frac.items():
            self._m_frac[s].set(f)
        for ex in keep:
            self._m_exemplars[ex["kind"]].inc()
            self._emit_exemplar(ex)

    def _classify_locked(self, wall, viol, degraded, req_stages, ts, *,
                         version, queue_depth, rows, admission_level):
        """Reservoir policy under the plane lock: violating / degraded
        always keep (bounded, newest win); healthy requests enter the
        slowest-N reservoir only if they beat its current floor.
        Returns the kept exemplar dict or None."""
        self._seq += 1
        if viol:
            kind = "violating"
        elif degraded:
            kind = "degraded"
        else:
            kind = "slow"
        dominant = max(req_stages, key=lambda s: req_stages[s])
        ex = {
            "kind": kind,
            "seq": self._seq,
            "time": time.time(),
            "wall_s": wall,
            "t0": ts,  # perf-counter submit stamp (span-tree anchor)
            "stages": dict(req_stages),
            "dominant_stage": dominant,
            "catalog_version": int(version),
            "degraded": bool(degraded),
            "violating": bool(viol),
            "queue_depth": int(queue_depth),
            "rows": rows,
            "bucket": None if rows is None else _pow2_bucket(rows),
            "admission_level": admission_level,
        }
        if kind != "slow":
            if len(self._kept) == self._kept.maxlen:
                self.kept_evicted += 1
            self._kept.append(ex)
            return ex
        if len(self._slow) < self.slow_keep:
            self._slow.append(ex)
            return ex
        floor = min(range(len(self._slow)),
                    key=lambda j: self._slow[j]["wall_s"])
        if wall > self._slow[floor]["wall_s"]:
            self._slow[floor] = ex
            return ex
        return None

    def note_shed(self, *, version: int, level: str = "shed",
                  burn: float | None = None,
                  queue_depth: int | None = None) -> None:
        """One request the admission ladder rejected — always kept (a
        shed IS the tail signal), with the rung and burn that drove it.
        No stages: the request never entered a flush."""
        ex = {
            "kind": "shed",
            "time": time.time(),
            "wall_s": 0.0,
            "stages": {},
            "dominant_stage": None,
            "catalog_version": int(version),
            "degraded": False,
            "violating": False,
            "queue_depth": queue_depth,
            "rows": None,
            "bucket": None,
            "admission_level": level,
            "burn_rate": None if burn is None else float(burn),
        }
        with self._lock:
            self._seq += 1
            ex["seq"] = self._seq
            self.shed += 1
            if len(self._kept) == self._kept.maxlen:
                self.kept_evicted += 1
            self._kept.append(ex)
        self._m_exemplars["shed"].inc()
        journal = get_events()
        if journal is not None:
            journal.emit("request.exemplar", severity="warning",
                         kind="shed", admission_level=level,
                         catalog_version=int(version),
                         burn_rate=ex["burn_rate"])

    def request_scope(self, version: int = 0):
        """Context manager timing one standalone request into the
        plane — for callers with no engine flush. ``mark(stage)`` on
        the scope attributes stages; the residual lands in
        ``host_post``."""
        return _RequestScope(self, version)

    # -- exemplar emission (tracer span tree + journal event) ----------------

    def _emit_exemplar(self, ex: dict) -> None:
        """Render one kept exemplar into the trace buffer as a span
        tree — a parent ``request`` complete-event over [submit, end]
        with back-to-back child stage spans reconstructed from the
        stage totals (a synthetic flame: stage ORDER is the canonical
        timeline order, not a measured interleaving) — plus one
        ``request.exemplar`` journal event carrying the ledger. Each
        exemplar renders on its own synthetic tid so overlapping
        requests of one flush don't stack."""
        tracer = get_tracer()
        t0 = ex.get("t0")
        if tracer.enabled and t0 is not None:
            tid = 0x52510000 + (ex["seq"] & 0xFFFF)  # 'RQ' namespace
            span_id = tracer.complete_tree(
                "request", t0, t0 + ex["wall_s"],
                [(f"request/{s}", ex["stages"].get(s, 0.0))
                 for s in STAGES],
                cat="request", child_cat="request_stage", tid=tid,
                kind=ex["kind"], catalog_version=ex["catalog_version"],
                queue_depth=ex["queue_depth"],
                dominant_stage=ex["dominant_stage"])
            ex["span_id"] = span_id
        journal = get_events()
        if journal is not None:
            journal.emit(
                "request.exemplar",
                severity="warning" if ex["kind"] == "violating" else "info",
                kind=ex["kind"], wall_ms=ex["wall_s"] * 1e3,
                dominant_stage=ex["dominant_stage"],
                catalog_version=ex["catalog_version"],
                queue_depth=ex["queue_depth"], bucket=ex["bucket"],
                admission_level=ex["admission_level"],
                exemplar_span_id=ex.get("span_id"))

    # -- reads ---------------------------------------------------------------

    def exemplars(self, limit: int | None = None) -> list[dict]:
        """The reservoir, worst-first (wall descending; sheds carry
        wall 0.0 and sort by recency among themselves)."""
        with self._lock:
            pool = list(self._kept) + list(self._slow)
        pool.sort(key=lambda e: (e["wall_s"], e["seq"]), reverse=True)
        return pool[:limit] if limit else pool

    def snapshot(self, limit: int | None = None) -> dict:
        """The ``/slowz`` body: window stage accounting (totals,
        fractions, the dominant stage), the wall window's tail
        quantiles, and the exemplar table worst-first."""
        with self._lock:
            walls = sorted(w for w, _, _ in self._win)
            fill = len(self._win)
            viol_win = self._win_viol
            totals = {s: self._sum_stages[j]
                      for j, s in enumerate(STAGES)}
            sum_wall = self._sum_wall
            kept = {"violating": 0, "degraded": 0, "shed": 0,
                    "slow": len(self._slow)}
            for e in self._kept:
                kept[e["kind"]] += 1
            evicted = self.kept_evicted
            count, violations, shed = self.count, self.violations, self.shed
        frac = ({} if sum_wall <= 0.0
                else {s: totals[s] / sum_wall for s in STAGES})
        dominant = (max(frac, key=lambda s: frac[s]) if frac else None)
        burn = ((viol_win / fill) / (1.0 - self.objective)
                if fill else 0.0)
        return {
            "time": time.time(),
            "name": self.name,
            "target_s": self.target_s,
            "objective": self.objective,
            "window": self.window,
            "window_fill": fill,
            "count": count,
            "violations": violations,
            "shed": shed,
            "burn_rate": burn,
            "p50_ms": _quantile(walls, 0.50) * 1e3,
            "p99_ms": _quantile(walls, 0.99) * 1e3,
            "stage_totals_s": totals,
            "stage_frac": frac,
            "dominant_stage": dominant,
            "exemplars": self.exemplars(limit),
            "kept": kept,
            "kept_evicted": evicted,
        }

    def stage_quantiles(self, qs=(0.50, 0.99)) -> dict:
        """Per-stage window quantiles ``{stage: {"p50": s, "p99": s}}``
        — the per-stage tail a benchmark round records
        (nearest-rank over the wall window, same rule as the p99 the
        snapshot reports)."""
        with self._lock:
            cols = {s: sorted(vals[j] for _, _, vals in self._win)
                    for j, s in enumerate(STAGES)}
        return {s: {f"p{int(q * 100)}": _quantile(col, q) for q in qs}
                for s, col in cols.items()}

    def reset(self) -> None:
        with self._lock:
            self._win.clear()
            self._win_viol = 0
            self._sum_wall = 0.0
            self._sum_stages = [0.0] * len(STAGES)
            self._kept.clear()
            self._slow.clear()
            self.kept_evicted = 0
            self.count = 0
            self.violations = 0
            self.shed = 0


class _RequestScope:
    """Times one standalone request and notes it on exit; ``mark``
    forwards to the owned ledger (residual → host_post)."""

    __slots__ = ("_telemetry", "_version", "_ledger")

    def __init__(self, telemetry: RequestTelemetry, version: int):
        self._telemetry = telemetry
        self._version = version
        self._ledger = None

    def mark(self, stage: str) -> None:
        if self._ledger is not None:
            self._ledger.mark(stage)

    def __enter__(self):
        self._ledger = FlushLedger(time.perf_counter())
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        self._telemetry.note_flush(self._ledger, end,
                                   (self._ledger.t0,),
                                   version=self._version)
        return False


class RequestStageCheck:
    """``HealthMonitor`` gate over the stage windows: OK while the SLO
    holds or no stage dominates; DEGRADED when one stage's window
    fraction exceeds ``frac_bar`` WHILE the plane's burn rate is over
    budget — a burning SLO with a named culprit is actionable, a
    dominant stage inside budget is just a profile. (DEGRADED, not
    CRITICAL: the engine is still serving.)"""

    def __init__(self, telemetry: RequestTelemetry,
                 frac_bar: float = 0.5):
        if not 0.0 < frac_bar <= 1.0:
            raise ValueError(f"frac_bar must be in (0, 1], got {frac_bar}")
        self.telemetry = telemetry
        self.frac_bar = float(frac_bar)

    def __call__(self):
        from large_scale_recommendation_tpu_torch.obs.health import degraded, ok

        snap = self.telemetry.snapshot(limit=0)
        dominant = snap["dominant_stage"]
        frac = snap["stage_frac"].get(dominant, 0.0) if dominant else 0.0
        burning = snap["burn_rate"] > 1.0
        if burning and dominant is not None and frac > self.frac_bar:
            return degraded(
                note=(f"stage {dominant} is {frac:.0%} of request time "
                      f"while burn_rate={snap['burn_rate']:.2f}"),
                dominant_stage=dominant, frac=frac,
                burn_rate=snap["burn_rate"],
                p99_ms=snap["p99_ms"])
        return ok(dominant_stage=dominant, frac=frac,
                  burn_rate=snap["burn_rate"],
                  window_fill=snap["window_fill"])


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by obs.enable_requests
# --------------------------------------------------------------------------

_REQUESTS: RequestTelemetry | None = None


def get_requests() -> RequestTelemetry | None:
    """The installed request telemetry or ``None``. Noting components
    cache this at construction and gate every seam on one ``is not
    None`` test — the same zero-cost discipline as ``get_budget``."""
    return _REQUESTS


def set_requests(telemetry: RequestTelemetry | None) -> None:
    global _REQUESTS
    _REQUESTS = telemetry


def request_scope(version: int = 0):
    """Time one standalone request into the plane; the shared no-op
    context (no clock reads, no allocation) when the plane is off."""
    t = get_requests()
    if t is None:
        return _NULL_CONTEXT
    return t.request_scope(version)


def slowz(limit: int | None = None) -> dict:
    """The ``/slowz`` endpoint body: the installed plane's snapshot,
    or the standard absent-plane note."""
    t = get_requests()
    if t is None:
        return {"note": "request telemetry not enabled "
                        "(obs.enable_requests)",
                "exemplars": []}
    return t.snapshot(limit)
