"""Catalog lineage: ingest → train → swap → serve provenance
(counterpart of ``large_scale_recommendation_tpu.obs.lineage``).

Every ``RecResult`` carries the ``catalog_version`` that answered it, and
the streaming driver knows which WAL offsets fed each swap;
``LineageJournal`` is the join:

- **swap provenance** — every catalog swap site
  (``ServingEngine.refresh`` / ``apply_delta``, ``AdaptiveMF._install``,
  ``StreamingDriver.refresh_serving``) stamps ``{catalog_version,
  wal_offset_watermark, train_step, retrain_id, wall_time, source}`` via
  ``record_swap``. Records upsert by version: the engine stamps the swap
  the instant it happens, the driver / adaptive layers enrich the same
  record with the watermark, step and retrain id they alone know — one
  record per servable build, however many sites saw it.
- **ingest watermarks** — the driver notes each applied batch's
  ``(end_offset, wall_time)`` (``note_ingest``, a bounded deque append),
  which prices a swap's **ingest→servable freshness**
  (``lineage_ingest_to_servable_s`` histogram, observed per swap).
- **the serve-side join** — ``observe_serve(version)`` (every engine
  flush) resolves the served version against the journal and publishes
  the **staleness gauge** (``lineage_staleness_s``: the age of the build
  answering requests now) plus resolve counters
  (``lineage_serve_joins_total{resolved=}``).
- **the freshness SLO** — ``FreshnessCheck`` (``HealthMonitor
  .watch_freshness``) pages when ingest has advanced past the newest
  swap's watermark and the oldest not-yet-servable record has waited
  longer than ``degraded_after_s`` / ``critical_after_s``.

The version keys are the engine's own version token
(``parallel.serving.catalog_version``). ``/lineagez`` (``obs.server``)
serves the journal; postmortem bundles freeze it (``lineage.json``).
Zero-cost when unused: the module default is ``None`` (``get_lineage``),
every stamping site is one ``is not None`` test, and
``obs.enable_lineage()`` installs one.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from large_scale_recommendation_tpu_torch.obs.registry import get_registry

# provenance fields a swap record carries (beyond bookkeeping);
# ``watermarks`` is the per-partition form of ``wal_offset_watermark``
# (which keeps the flat max for the single-partition reading)
PROVENANCE_FIELDS = ("catalog_version", "wal_offset_watermark",
                     "watermarks", "train_step", "retrain_id",
                     "wall_time", "source", "verdict", "verdict_reason",
                     "verdict_time", "rolled_back")

# the rollout verdicts obs.budget stamps (plus bookkeeping on the act)
VERDICTS = ("PROMOTE", "HOLD", "ROLLBACK")


class LineageJournal:
    """Bounded provenance store keyed by catalog version.

    ``capacity`` bounds the record table (oldest versions evict — a
    version older than the eviction horizon is months of swaps away
    from still serving); ``ingest_marks`` bounds the ingest-watermark
    deque. Thread-safe: swaps land from serving/driver/retrain threads
    while ``/lineagez`` scrapes and flushes join concurrently.
    """

    def __init__(self, capacity: int = 1024, ingest_marks: int = 512,
                 registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._records: OrderedDict[int, dict] = OrderedDict()
        self._ingest: deque[tuple[int, int, float]] = deque(
            maxlen=int(ingest_marks))  # (partition, end_offset, t)
        self._lock = threading.Lock()
        self._seq = 0
        self.swaps = 0       # lifetime record_swap calls
        self.evicted = 0
        obs = registry or get_registry()
        self._obs = obs
        self._m_swaps = obs.counter("lineage_swaps_total")
        self._m_verdicts = obs.counter("lineage_verdicts_total")
        self._m_staleness = obs.gauge("lineage_staleness_s")
        self._m_freshness = obs.histogram("lineage_ingest_to_servable_s")
        self._m_joins = {
            True: obs.counter("lineage_serve_joins_total", resolved="true"),
            False: obs.counter("lineage_serve_joins_total",
                               resolved="false"),
        }

    # -- swap provenance -----------------------------------------------------

    def record_swap(self, catalog_version: int, *,
                    wal_offset_watermark: int | None = None,
                    partition: int = 0,
                    train_step: int | None = None,
                    retrain_id: int | None = None,
                    source: str | None = None,
                    wall_time: float | None = None) -> dict:
        """Upsert one swap's provenance. The FIRST stamp of a version
        creates the record (its ``wall_time`` is the swap instant);
        later stamps merge their non-None fields in — the engine stamps
        at the swap, the driver enriches with the watermark it alone
        knows, and the record stays one per servable build.

        Watermarks are PER PARTITION (``watermarks: {partition:
        offset}``; a multi-partition build — an adaptive retrain over
        several drivers' history — stamps once per partition): WAL
        offsets from different partitions are independent number
        spaces, and comparing them as one line would make a high-offset
        partition's ingest read as permanently "ahead" of a low-offset
        partition's swap. ``wal_offset_watermark`` on the record keeps
        the flat single-partition reading (the max across partitions)."""
        now = time.time() if wall_time is None else float(wall_time)
        version = int(catalog_version)
        freshness_s = None
        with self._lock:
            rec = self._records.get(version)
            created = rec is None
            if created:
                self._seq += 1
                rec = {"catalog_version": version, "wall_time": now,
                       "wal_offset_watermark": None, "watermarks": {},
                       "train_step": None, "retrain_id": None,
                       "source": source, "seq": self._seq}
                self._records[version] = rec
                while len(self._records) > self.capacity:
                    self._records.popitem(last=False)
                    self.evicted += 1
            new_mark = False
            if wal_offset_watermark is not None:
                p = int(partition)
                prev_w = rec["watermarks"].get(p)
                if prev_w is None or int(wal_offset_watermark) > prev_w:
                    rec["watermarks"][p] = int(wal_offset_watermark)
                    new_mark = prev_w is None
                rec["wal_offset_watermark"] = max(
                    rec["watermarks"].values())
            if train_step is not None:
                rec["train_step"] = int(train_step)
            if retrain_id is not None:
                rec["retrain_id"] = int(retrain_id)
            if source is not None:
                rec["source"] = source
            self.swaps += 1
            # ingest→servable freshness: priced once per (record,
            # partition), when the partition's watermark FIRST lands —
            # the newest noted ingest of THAT partition covered by it
            # tells how long data waited to become servable
            if new_mark:
                w = rec["watermarks"][p]
                newest = None
                for pt, off, t in self._ingest:
                    if pt == p and off <= w:
                        newest = t if newest is None else max(newest, t)
                if newest is not None:
                    freshness_s = max(0.0, rec["wall_time"] - newest)
            out = dict(rec)
            out["watermarks"] = dict(rec["watermarks"])
        self._m_swaps.inc()
        if freshness_s is not None:
            self._m_freshness.observe(freshness_s)
        return out

    def record_verdict(self, catalog_version: int, verdict: str, *,
                       reason: str | None = None,
                       acted: bool | None = None,
                       wall_time: float | None = None) -> dict:
        """Stamp a rollout verdict (``obs.budget.CanaryVerdictEngine``)
        onto the version's provenance record — the postmortem join
        "which build was rolled back, and why" reads straight off
        ``/lineagez``. Upserts like ``record_swap`` (a verdict can land
        before the serving host's own swap stamp); ``acted=True`` marks
        the rollback as executed (``rolled_back``), which is what
        clears the ``RolloutCheck`` page."""
        if verdict not in VERDICTS:
            raise ValueError(
                f"verdict must be one of {VERDICTS}, got {verdict!r}")
        now = time.time() if wall_time is None else float(wall_time)
        version = int(catalog_version)
        with self._lock:
            rec = self._records.get(version)
            if rec is None:
                self._seq += 1
                rec = {"catalog_version": version, "wall_time": now,
                       "wal_offset_watermark": None, "watermarks": {},
                       "train_step": None, "retrain_id": None,
                       "source": None, "seq": self._seq}
                self._records[version] = rec
                while len(self._records) > self.capacity:
                    self._records.popitem(last=False)
                    self.evicted += 1
            rec["verdict"] = verdict
            if reason is not None:
                rec["verdict_reason"] = reason
            rec["verdict_time"] = now
            if acted is not None:
                rec["rolled_back"] = bool(acted)
            out = dict(rec)
            out["watermarks"] = dict(rec["watermarks"])
        self._m_verdicts.inc()
        return out

    def note_ingest(self, end_offset: int, partition: int = 0,
                    t: float | None = None) -> None:
        """Mark ingest progress: ``end_offset`` records of ``partition``
        have been applied as of ``t``. One bounded deque append — the
        per-batch cost of the whole freshness story."""
        with self._lock:
            self._ingest.append((int(partition), int(end_offset),
                                 time.time() if t is None else float(t)))

    # -- the serve-side join -------------------------------------------------

    def resolve(self, catalog_version: int) -> dict | None:
        """The provenance record a served ``RecResult.catalog_version``
        joins to, or None (evicted / never stamped)."""
        with self._lock:
            rec = self._records.get(int(catalog_version))
            if rec is None:
                return None
            out = dict(rec)
            out["watermarks"] = dict(rec["watermarks"])
            return out

    def observe_serve(self, catalog_version: int,
                      requests: int = 1) -> float | None:
        """Join one flush's served version against the journal: publish
        the per-request staleness gauge (age of the servable build) and
        the resolve counters. Returns the staleness in seconds (None
        when the version doesn't resolve).

        NON-BLOCKING on the journal lock: this runs on the serving path
        — and on the ``recommend()`` path still inside the engine's
        re-entrant lock — while the same journal lock serializes
        ``/lineagez`` scrapes, ``freshness()`` evaluations, and bundle
        freezes. A scrape must never add tail latency to the
        SLO-measured flush, so under contention the join SKIPS this
        tick (the staleness gauge is a sample; the next flush re-prices
        it) rather than wait."""
        if not self._lock.acquire(blocking=False):
            return None  # contended: skip the sample, never stall serving
        try:
            rec = self._records.get(int(catalog_version))
            wall_time = None if rec is None else rec["wall_time"]
        finally:
            self._lock.release()
        self._m_joins[rec is not None].inc(requests)
        if wall_time is None:
            return None
        staleness = max(0.0, time.time() - wall_time)
        self._m_staleness.set(staleness)
        return staleness

    # -- freshness state -----------------------------------------------------

    def freshness(self) -> dict:
        """The servable-watermark summary ``FreshnessCheck`` verdicts
        on, computed PER PARTITION (WAL offsets from different
        partitions are independent number spaces): for each partition
        with ingest marks, the servable watermark is the highest any
        record carries for it, the marks past it are
        ingested-but-unservable, and the OLDEST such mark's wait is the
        partition's staleness age. The flat top-level fields aggregate
        worst-wins (any partition ahead → ``ingest_ahead``; the oldest
        wait across partitions → ``unservable_age_s``) so the
        single-partition reading is unchanged."""
        now = time.time()
        with self._lock:
            records = [dict(r, watermarks=dict(r["watermarks"]))
                       for r in self._records.values()]
            ingest = list(self._ingest)
            n_records = len(records)
        watermarked = [r for r in records if r["watermarks"]]
        newest_swap = (max(watermarked, key=lambda r: r["wall_time"])
                       if watermarked else None)
        # per-partition servable frontier: the highest watermark ANY
        # record carries for that partition
        servable: dict[int, int] = {}
        for r in records:
            for p, w in r["watermarks"].items():
                servable[p] = max(servable.get(p, w), w)
        marks_by_part: dict[int, list] = {}
        for p, off, t in ingest:
            marks_by_part.setdefault(p, []).append((off, t))
        partitions: dict[int, dict] = {}
        any_ahead = False
        worst_age = None
        for p, marks in sorted(marks_by_part.items()):
            w = servable.get(p)
            # no watermark for this partition at all → everything it
            # ingested is waiting to become servable
            behind = [t for off, t in marks if w is None or off > w]
            age = round(now - min(behind), 3) if behind else None
            partitions[p] = {
                "servable_watermark": w,
                "latest_ingest_offset": max(off for off, _ in marks),
                "ingest_ahead": bool(behind),
                "unservable_age_s": age,
            }
            if behind:
                any_ahead = True
                worst_age = age if worst_age is None else max(worst_age,
                                                              age)
        out = {"time": now, "records": n_records,
               "servable_watermark": None, "servable_swap_age_s": None,
               "latest_ingest_offset": None, "ingest_ahead": any_ahead,
               "unservable_age_s": worst_age, "partitions": partitions}
        if newest_swap is not None:
            out["servable_watermark"] = newest_swap["wal_offset_watermark"]
            out["servable_swap_age_s"] = round(
                now - newest_swap["wall_time"], 3)
        if ingest:
            out["latest_ingest_offset"] = max(off for _, off, _ in ingest)
        return out

    # -- reads ---------------------------------------------------------------

    def tail(self, n: int = 50) -> list[dict]:
        """The newest ``n`` provenance records, oldest→newest."""
        with self._lock:
            recs = [dict(r, watermarks=dict(r["watermarks"]))
                    for r in list(self._records.values())[-n:]]
        return recs

    def snapshot(self, limit: int | None = None) -> dict:
        """The ``/lineagez`` body: provenance records + freshness
        summary + accounting."""
        with self._lock:
            recs = [dict(r, watermarks=dict(r["watermarks"]))
                    for r in self._records.values()]
            swaps, evicted = self.swaps, self.evicted
        if limit is not None and len(recs) > limit:
            recs = recs[-limit:]
        return {"time": time.time(), "records": recs,
                "returned": len(recs), "swaps": swaps,
                "evicted": evicted, "capacity": self.capacity,
                "freshness": self.freshness()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class FreshnessCheck:
    """Ingest→serve staleness SLO for ``HealthMonitor``: pages when
    records keep landing in the WAL while the servable watermark stands
    still. OK while the newest watermarked swap covers the newest
    ingest (nothing new to serve — an idle stream is not an incident),
    and OK before any swap has a watermark only when nothing has been
    ingested either; once ingest is ahead, the OLDEST unservable
    record's wait verdicts: ≥ ``degraded_after_s`` → DEGRADED, ≥
    ``critical_after_s`` → CRITICAL. The thresholds are an operational
    freshness SLO (seconds of ingest→serve lag), not a per-model
    quality number."""

    def __init__(self, lineage: LineageJournal, degraded_after_s: float,
                 critical_after_s: float | None = None):
        if degraded_after_s < 0:
            raise ValueError(
                f"degraded_after_s must be >= 0, got {degraded_after_s}")
        if (critical_after_s is not None
                and critical_after_s < degraded_after_s):
            raise ValueError(
                f"critical_after_s ({critical_after_s}) must be >= "
                f"degraded_after_s ({degraded_after_s})")
        self.lineage = lineage
        self.degraded_after_s = float(degraded_after_s)
        self.critical_after_s = (None if critical_after_s is None
                                 else float(critical_after_s))

    def __call__(self):
        from large_scale_recommendation_tpu_torch.obs.health import (
            critical,
            degraded,
            ok,
        )

        f = self.lineage.freshness()
        detail = {k: f[k] for k in ("servable_watermark",
                                    "servable_swap_age_s",
                                    "latest_ingest_offset",
                                    "ingest_ahead", "unservable_age_s",
                                    "partitions")}
        if f["latest_ingest_offset"] is None:
            return ok(note="no ingest observed", **detail)
        if f["servable_watermark"] is None:
            # ingest is flowing but nothing has ever become servable:
            # that IS the staleness incident from the first record on
            detail["note"] = "ingest flowing, no servable watermark yet"
        elif not f["ingest_ahead"]:
            return ok(**detail)
        age = f["unservable_age_s"]
        if age is None:
            # no ingest mark survives past the watermark (ring evicted
            # them) — fall back to the swap's own age as the bound
            age = f["servable_swap_age_s"] or 0.0
            detail["age_from"] = "swap_age_fallback"
        if self.critical_after_s is not None and age >= self.critical_after_s:
            return critical(**detail)
        if age >= self.degraded_after_s:
            return degraded(**detail)
        return ok(**detail)


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by obs.enable_lineage
# --------------------------------------------------------------------------

_LINEAGE: LineageJournal | None = None


def get_lineage() -> LineageJournal | None:
    """The installed lineage journal or ``None``. Stamping components
    cache this at construction and gate every stamp on one ``is not
    None`` test — the same zero-cost discipline as ``get_events``."""
    return _LINEAGE


def set_lineage(journal: LineageJournal | None) -> None:
    global _LINEAGE
    _LINEAGE = journal
