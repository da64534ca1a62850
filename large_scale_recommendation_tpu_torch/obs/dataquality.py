"""Ingest data-quality gate: per-batch inspection in front of training
(counterpart of ``large_scale_recommendation_tpu.obs.dataquality``).

The training path is deliberately tolerant (poison rows quarantine at the
queue, weight-0 rows no-op), so bad data degrades silently.
``DataQualityInspector`` runs in front of ``OnlineMF.partial_fit``
(``streams.driver``'s ``inspector`` hook, one ``is not None`` test per
batch when unattached) and checks every micro-batch's host arrays, before
anything is staged to the card, for

- **non-finite values** (NaN / Inf ratings),
- **out-of-range ratings** (outside ``rating_range``),
- **out-of-vocab ids** (negative, or past the configured ceilings),
- **duplicate keys** (repeated ``(user, item)`` pairs within a batch),
- **arrival-rate skew** (per-partition record rates over a sliding
  window),

publishes per-class counters / fraction gauges, journals one
``data.quality_violation`` event per offending batch, and keeps a bounded
window of per-batch violation fractions that ``obs.health.DataQualityCheck``
turns into DEGRADED / CRITICAL verdicts. A ``StreamBatch`` from the WAL
has had its poison records (non-finite ratings, negative ids) quarantined
by the queue already; the inspector sees what reaches training.

The inspector observes and reports; it never mutates or drops a batch.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.registry import get_registry

# violation taxonomy, one fraction gauge + counter per class
VIOLATION_CLASSES = ("non_finite", "out_of_range", "out_of_vocab",
                     "duplicate_key")


class DataQualityInspector:
    """Per-batch data-quality inspection with a windowed verdict.

    ``rating_range=(lo, hi)`` arms the range check (None = skip);
    ``max_user_id``/``max_item_id`` arm the vocabulary ceilings
    (ids < 0 always count — a negative id is out-of-vocab in every
    schema). ``window`` batches of per-class violation fractions back
    the health verdict, so one bad batch degrades for a window, not
    for a single scrape (the ``StreamHealthCheck`` stickiness lesson).
    ``skew_threshold`` is the max/min per-partition arrival-rate ratio
    above which arrival skew flags (needs ≥ 2 partitions seen within
    ``skew_window_s``).

    ``class_policy`` overrides the (degraded, critical) fraction pair
    PER CLASS: workloads differ in which violations are structural —
    a dense small-vocabulary stream (or any replayed/retried feed)
    carries a high NATURAL ``duplicate_key`` rate that says nothing
    about corruption, while a single NaN is always news. E.g.
    ``class_policy={"duplicate_key": (0.3, 0.8)}`` keeps the tight
    default for the corruption classes and prices duplicates at the
    workload's own baseline.
    """

    def __init__(self, rating_range: tuple[float, float] | None = None,
                 max_user_id: int | None = None,
                 max_item_id: int | None = None,
                 degraded_frac: float = 0.01,
                 critical_frac: float = 0.10,
                 class_policy: dict | None = None,
                 window: int = 64,
                 skew_threshold: float = 10.0,
                 skew_window_s: float = 60.0,
                 registry=None):
        if not 0.0 < degraded_frac <= critical_frac:
            raise ValueError(
                f"need 0 < degraded_frac <= critical_frac, got "
                f"({degraded_frac}, {critical_frac})")
        self.class_policy: dict[str, tuple[float, float]] = {}
        for cls, pair in (class_policy or {}).items():
            if cls not in VIOLATION_CLASSES:
                raise ValueError(
                    f"unknown violation class {cls!r}; expected one of "
                    f"{VIOLATION_CLASSES}")
            lo, hi = float(pair[0]), float(pair[1])
            if not 0.0 < lo <= hi:
                raise ValueError(
                    f"class_policy[{cls!r}] needs 0 < degraded <= "
                    f"critical, got ({lo}, {hi})")
            self.class_policy[cls] = (lo, hi)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.rating_range = (None if rating_range is None else
                             (float(rating_range[0]),
                              float(rating_range[1])))
        self.max_user_id = max_user_id
        self.max_item_id = max_item_id
        self.degraded_frac = float(degraded_frac)
        self.critical_frac = float(critical_frac)
        self.window = int(window)
        self.skew_threshold = float(skew_threshold)
        self.skew_window_s = float(skew_window_s)
        self._lock = threading.Lock()
        # recent per-batch fractions per class (bounded: the verdict
        # window IS the memory bound)
        self._recent: dict[str, deque] = {
            c: deque(maxlen=self.window) for c in VIOLATION_CLASSES}
        # per-partition (t, records) arrival marks for the skew check
        self._arrivals: dict[int, deque] = {}
        self.batches = 0
        self.records = 0
        self.violations = {c: 0 for c in VIOLATION_CLASSES}
        self.last_skew: float = 1.0
        obs = registry or get_registry()
        self._obs = obs
        self._events = get_events()
        self._m_batches = obs.counter("dataq_batches_total")
        self._m_records = obs.counter("dataq_records_total")
        self._m_viol = {c: obs.counter("dataq_violations_total", cls=c)
                        for c in VIOLATION_CLASSES}
        self._m_frac = {c: obs.gauge("dataq_violation_frac", cls=c)
                        for c in VIOLATION_CLASSES}
        self._m_skew = obs.gauge("dataq_partition_skew")

    # -- inspection ----------------------------------------------------------

    def inspect(self, users, items, ratings, weights=None,
                partition: int = 0) -> dict:
        """Inspect one batch of raw arrays; returns the per-class
        violation-count dict. Weight-0 rows (padding, already-
        quarantined poison) are excluded from every check — they never
        reach a kernel either."""
        users = np.asarray(users)
        items = np.asarray(items)
        ratings = np.asarray(ratings)
        if weights is not None:
            real = np.asarray(weights) > 0
            users, items, ratings = users[real], items[real], ratings[real]
        n = len(ratings)
        counts = {c: 0 for c in VIOLATION_CLASSES}
        if n:
            finite = np.isfinite(ratings)
            counts["non_finite"] = int((~finite).sum())
            if self.rating_range is not None:
                lo, hi = self.rating_range
                counts["out_of_range"] = int(
                    (finite & ((ratings < lo) | (ratings > hi))).sum())
            oov = (users < 0) | (items < 0)
            if self.max_user_id is not None:
                oov |= users > self.max_user_id
            if self.max_item_id is not None:
                oov |= items > self.max_item_id
            counts["out_of_vocab"] = int(oov.sum())
            # duplicate (user, item) keys within the batch: every
            # occurrence past the first counts (3 copies = 2 dupes).
            # Column-wise unique, NOT a packed scalar key: a corrupt
            # feed's negative / ≥2³¹ ids (exactly the batches this
            # inspector exists to catch) would make distinct pairs
            # collide under any fixed packing base and inflate the
            # duplicate class for a violation that did not occur
            pairs = np.stack([users.astype(np.int64),
                              items.astype(np.int64)], axis=1)
            counts["duplicate_key"] = int(
                n - len(np.unique(pairs, axis=0)))
        now = time.time()
        with self._lock:
            self.batches += 1
            self.records += n
            for c, v in counts.items():
                self.violations[c] += v
                self._recent[c].append(v / n if n else 0.0)
            marks = self._arrivals.setdefault(int(partition), deque())
            marks.append((now, n))
            skew = self._skew_locked(now)
            self.last_skew = skew
        self._m_batches.inc()
        self._m_records.inc(n)
        self._m_skew.set(skew)
        flagged = {c: v for c, v in counts.items() if v}
        for c, v in flagged.items():
            self._m_viol[c].inc(v)
        for c in VIOLATION_CLASSES:
            self._m_frac[c].set(counts[c] / n if n else 0.0)
        if flagged and self._events is not None:
            error = any(
                n and v / n >= self.class_policy.get(
                    c, (self.degraded_frac, self.critical_frac))[1]
                for c, v in flagged.items())
            self._events.emit(
                "data.quality_violation",
                severity="error" if error else "warning",
                partition=int(partition), records=n, **flagged)
        return counts

    def inspect_batch(self, batch) -> dict:
        """The ``streams.driver`` form: one ``StreamBatch`` in."""
        ru, ri, rv, rw = batch.ratings.to_numpy()
        return self.inspect(ru, ri, rv, weights=rw,
                            partition=batch.partition)

    def _skew_locked(self, now: float) -> float:
        """max/min per-partition arrival rate over the sliding time
        window; 1.0 (no skew) until ≥ 2 partitions have recent
        arrivals — a single-consumer stream can't be skewed. Max/MIN,
        not max/mean: with two partitions max/mean saturates at 2
        regardless of how dead the starved feed is, while max/min is
        exactly the dying-feed ratio the check wants (a partition with
        no recent arrivals at all drops out of the window — the lag
        check owns fully-dead feeds)."""
        horizon = now - self.skew_window_s
        rates = []
        for marks in self._arrivals.values():
            while marks and marks[0][0] < horizon:
                marks.popleft()
            if marks:
                rates.append(sum(r for _, r in marks))
        if len(rates) < 2:
            return 1.0
        return max(rates) / max(min(rates), 1)

    # -- the health-check surface --------------------------------------------

    def status(self) -> tuple[str, dict]:
        """(status, detail) over the recent window: worst class wins.
        WORST recent per-batch violation fraction ≥ ``critical_frac``
        → CRITICAL, ≥ ``degraded_frac`` → DEGRADED (max over the
        window, not mean — one 60%-poisoned batch is an incident even
        when its clean neighbours would average it under the bar);
        arrival skew ≥ ``skew_threshold`` → DEGRADED (a starving feed
        is an operational page, not a data-corruption page). The window
        makes the verdict sticky for ``window`` batches — per-request
        ``/healthz`` evaluation can't consume it."""
        from large_scale_recommendation_tpu_torch.obs.health import (
            CRITICAL,
            DEGRADED,
            OK,
        )

        with self._lock:
            fracs = {c: (max(d) if d else 0.0)
                     for c, d in self._recent.items()}
            skew = self.last_skew
            detail = {"batches": self.batches, "records": self.records,
                      "window_worst_frac": {c: round(f, 5)
                                            for c, f in fracs.items()},
                      "violations": dict(self.violations),
                      "partition_skew": round(skew, 3)}
        worst = OK
        offenders = {c: f for c, f in fracs.items() if f > 0}
        if offenders:
            detail["offending"] = sorted(offenders)
            sev = {OK: 0, DEGRADED: 1, CRITICAL: 2}
            for cls, frac in offenders.items():
                lo, hi = self.class_policy.get(
                    cls, (self.degraded_frac, self.critical_frac))
                verdict = (CRITICAL if frac >= hi
                           else DEGRADED if frac >= lo else OK)
                if sev[verdict] > sev[worst]:
                    worst = verdict
        if worst != CRITICAL and skew >= self.skew_threshold:
            worst = DEGRADED
            detail["skewed"] = True
        return worst, detail

    def snapshot(self) -> dict:
        """JSON-safe state for bundles / reports."""
        status, detail = self.status()
        return {"status": status, **detail,
                "policy": {"degraded_frac": self.degraded_frac,
                           "critical_frac": self.critical_frac,
                           "class_policy": {c: list(p) for c, p in
                                            self.class_policy.items()},
                           "window": self.window,
                           "skew_threshold": self.skew_threshold,
                           "rating_range": self.rating_range,
                           "max_user_id": self.max_user_id,
                           "max_item_id": self.max_item_id}}
