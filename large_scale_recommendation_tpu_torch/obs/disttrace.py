"""End-to-end distributed tracing: cross-process trace identity, pod
trace assembly and ingest→servable critical-path attribution (counterpart
of ``large_scale_recommendation_tpu.obs.disttrace``).

The lineage plane prices "how long until a rating is servable" as one
histogram (``lineage_ingest_to_servable_s``); this module says where the
time went, and joins the per-process tracers:

- **cross-process trace identity** — ``record_trace_id(partition,
  offset)`` derives a record's trace id from its durable WAL identity, so
  every process computes the same id with no side channel: the offsets are
  the causal tokens that cross the process boundary. In-process,
  ``obs.trace.TraceContext`` carries the id (and a parent span): stamped at
  WAL append (``streams.log``), minted per micro-batch
  (``streams.sources``), activated around each apply (``streams.driver``),
  and re-entered on ``AdaptiveMF``'s background retrain thread.
- **pod trace assembly** — ``assemble_pod_trace`` merges per-process
  Chrome-trace exports (of either package) into one Perfetto-loadable
  timeline (re-homed synthetic pids + ``process_name`` metadata).
  ``resolve_record_trace`` resolves one record id to its chain WAL append
  → ingest batch → partial_fit → catalog swap → first servable flush,
  joined by offset ranges, watermarks and catalog versions. Served
  pod-wide at ``/podtracez`` on the ``FleetServer``.
- **critical-path attribution** — ``CriticalPathAnalyzer`` decomposes each
  sampled record's ingest→servable wall into ``queue_wait`` /
  ``train_apply`` / ``swap_lag`` / ``flush_wait``, published as
  ``critical_path_s{stage}`` gauges (+ ``critical_path_total_s``) and
  served at ``/criticalpathz``. The swap marks reuse the lineage record's
  own ``wall_time`` and the applied marks share the ingest mark's clock
  read, so ``swap_lag`` reconciles exactly against
  ``lineage_ingest_to_servable_s``, and ``total_s`` is the stage sum.

Every mark is a host wall-clock read; ``train_apply`` covers the host's
apply call, which on the card returns once the step's kernels are queued
(the online update reads no tensor back), so the card's time of one batch
shows in the next batch's apply or at the swap.

Zero-cost when unused: the module default is ``None``
(``get_disttrace``), every stamping site is one ``is not None`` test, trace
stamps gate on ``tracer.enabled``, and ``obs.enable_disttrace()``
installs an analyzer.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from large_scale_recommendation_tpu_torch.obs.registry import get_registry

# the stage taxonomy:
#   queue_wait  — WAL append → apply start (WAL tail + ingest queue)
#   train_apply — apply start → offset stamped (the model update)
#   swap_lag    — offset stamped → first covering catalog swap
#                 (== the lineage_ingest_to_servable_s sample)
#   flush_wait  — covering swap → first flush serving that version
STAGES = ("queue_wait", "train_apply", "swap_lag", "flush_wait")


def record_trace_id(partition: int, offset: int) -> str:
    """The deterministic trace id of one WAL record — a pure function
    of the record's durable identity, so any process derives it with
    no context ever serialized onto the wire: the partitioned offsets
    are the propagation mechanism. NOTE the ids stamped on spans derive
    from each span's own FIRST record (an append batch's or a
    micro-batch's), and producer/consumer batch boundaries need not
    align — the cross-process JOIN is therefore by offset-range
    coverage (``resolve_record_trace``), with the ids as human-readable
    trace names, not equality keys."""
    return f"wal-p{int(partition)}-o{int(offset)}"


# --------------------------------------------------------------------------
# Pod trace assembly
# --------------------------------------------------------------------------


def assemble_pod_trace(sources) -> dict:
    """Merge per-process Chrome-trace documents into ONE
    Perfetto-loadable pod timeline.

    ``sources`` is an iterable of ``(label, doc)`` pairs (label: the
    host/process name; doc: a ``chrome_trace()`` document or a bare
    event list). Each source's events are re-homed onto a synthetic pid
    (its index) with a ``process_name`` metadata row carrying the
    label — two processes (or two hosts) with colliding OS pids/tids
    can never collide in the merged artifact, which therefore passes
    ``validate_chrome_trace``. Args are preserved verbatim: span/event
    ids are already ``(host, pid)``-namespaced, so event↔span and
    parent↔child joins keep working after the merge."""
    merged: list[dict] = []
    labels: list[str] = []
    for idx, (label, doc) in enumerate(sources):
        if isinstance(doc, dict):
            events = doc.get("traceEvents", [])
        else:
            events = list(doc)
        labels.append(str(label))
        merged.append({"name": "process_name", "ph": "M", "pid": idx,
                       "tid": 0, "args": {"name": str(label)}})
        for e in events:
            e2 = dict(e)
            e2["pid"] = idx
            merged.append(e2)
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "podSources": labels}


def resolve_record_trace(doc: dict, partition: int, offset: int) -> dict:
    """Resolve one WAL record id to its assembled distributed trace.

    Walks a (possibly pod-merged) Chrome-trace document for the causal
    chain of record ``offset`` of ``partition``:

    1. ``wal/append``        — the append span whose offset range
       covers the record (the producer process's clock);
    2. ``stream/ingest_batch`` — the driver apply span covering it;
    3. ``online/partial_fit``  — the model-update span nested inside
       the ingest span (same pid/tid, contained interval);
    4. ``lineage/swap_watermark`` — the EARLIEST swap instant whose
       watermark covers the record (the build that made it servable);
    5. ``serving/flush``     — the first flush serving that build's
       ``catalog_version``.

    Returns ``{trace_id, record, hops, found, missing, complete,
    processes, stages}``: ``hops`` are the matched events (name, pid,
    tid, span_id, ts/dur), ``processes`` the distinct pids on the chain
    (≥ 2 proves the trace crossed a process boundary), ``stages`` the
    wall decomposition in seconds computed from the events' (epoch-
    anchored) timestamps. ``complete`` is True when every hop
    resolved."""
    p, off = int(partition), int(offset)
    evs = [e for e in doc.get("traceEvents", [])
           if e.get("ph") in ("X", "i")]

    def covers(e):
        a = e.get("args", {})
        s, n = a.get("start_offset"), a.get("end_offset")
        return (a.get("partition") == p and s is not None
                and n is not None and s <= off < n)

    def first(name, pred):
        cand = [e for e in evs if e["name"] == name and pred(e)]
        return min(cand, key=lambda e: e["ts"]) if cand else None

    wal = first("wal/append", covers)
    ingest = first("stream/ingest_batch", covers)
    fit = None
    if ingest is not None:
        lo, hi = ingest["ts"], ingest["ts"] + ingest["dur"]
        fits = [e for e in evs
                if e["name"] == "online/partial_fit" and e["ph"] == "X"
                and e["pid"] == ingest["pid"]
                and e["tid"] == ingest["tid"]
                # sub-µs JSON wiggle tolerance, same as the validator
                and lo - 0.5 <= e["ts"]
                and e["ts"] + e["dur"] <= hi + 0.5]
        fit = min(fits, key=lambda e: e["ts"]) if fits else None
    # catalog versions are a PER-PROCESS counter, not a pod-global one:
    # two consumer processes both mint version 3. The swap hop is
    # therefore pinned to the ingest hop's process (the driver that
    # applied the record is the one that stamps its covering
    # watermark), and the flush hop to the swap's process — without the
    # pid constraint a merged pod trace would conflate one process's
    # swap with another's unrelated same-numbered flush.
    swap = first(
        "lineage/swap_watermark",
        lambda e: (e.get("args", {}).get("partition") == p
                   and e["args"].get("watermark") is not None
                   and e["args"]["watermark"] > off
                   and (ingest is None or e["pid"] == ingest["pid"])))
    flush = None
    if swap is not None:
        ver = swap["args"].get("version")
        flushes = [e for e in evs if e["name"] == "serving/flush"
                   and e.get("args", {}).get("catalog_version") == ver
                   and e["pid"] == swap["pid"]]
        # the first flush ENDING at/after the swap: the moment the
        # build actually answered a request
        after = [e for e in flushes
                 if e["ts"] + e.get("dur", 0.0) >= swap["ts"]]
        pool = after or flushes
        flush = min(pool, key=lambda e: e["ts"]) if pool else None

    named = [("wal_append", wal), ("ingest_batch", ingest),
             ("partial_fit", fit), ("catalog_swap", swap),
             ("servable_flush", flush)]
    hops = [{"hop": n, "name": e["name"], "pid": e["pid"],
             "tid": e.get("tid"), "ts": e["ts"],
             "dur": e.get("dur", 0.0),
             "span_id": e.get("args", {}).get("span_id")}
            for n, e in named if e is not None]
    us = 1e-6
    stages: dict[str, float] = {}
    if wal is not None and ingest is not None:
        stages["queue_wait"] = max(0.0, (ingest["ts"] - wal["ts"]) * us)
    if ingest is not None:
        stages["train_apply"] = ingest["dur"] * us
    if ingest is not None and swap is not None:
        stages["swap_lag"] = max(
            0.0, (swap["ts"] - ingest["ts"] - ingest["dur"]) * us)
    if swap is not None and flush is not None:
        stages["flush_wait"] = max(
            0.0, (flush["ts"] + flush.get("dur", 0.0) - swap["ts"]) * us)
    return {
        "trace_id": record_trace_id(p, off),
        "record": {"partition": p, "offset": off},
        "hops": hops,
        "found": [n for n, e in named if e is not None],
        "missing": [n for n, e in named if e is None],
        "complete": all(e is not None for _, e in named),
        "processes": sorted({h["pid"] for h in hops}),
        "stages": stages,
    }


# --------------------------------------------------------------------------
# Critical-path attribution
# --------------------------------------------------------------------------


class CriticalPathAnalyzer:
    """Live ingest→servable critical-path attribution.

    Marks arrive from the data path, each site one ``is not None`` test
    plus a bounded deque append:

    - ``note_append`` — WAL append acked (``EventLog.append_arrays``);
    - ``note_dequeue`` — batch apply STARTED (``StreamingDriver``);
    - ``note_applied`` — offset stamped; shares the exact clock read of
      the lineage journal's ``note_ingest``;
    - ``note_swap`` — a catalog build's watermark first covered the
      partition; passes the lineage record's own ``wall_time`` so the
      ``swap_lag`` stage reconciles EXACTLY against
      ``lineage_ingest_to_servable_s``;
    - ``note_serve`` — an engine flush served a version (NON-BLOCKING,
      same rule as ``LineageJournal.observe_serve``: a contended
      analyzer must never add tail latency to the serving path).

    Each first-watermark swap completes one SAMPLE — the newest applied
    record the watermark covers, the identical sampling rule the
    lineage freshness histogram uses — decomposed into the ``STAGES``
    taxonomy and published as ``critical_path_s{stage}`` gauges plus
    ``critical_path_total_s`` (the stage sum by construction; the
    flight recorder keeps their history). ``flush_wait`` completes
    later, on the first flush of that version. ``snapshot()`` is the
    ``/criticalpathz`` body."""

    def __init__(self, capacity: int = 256, marks: int = 1024,
                 registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._append: deque = deque(maxlen=int(marks))   # (p, end, t)
        self._dequeue: deque = deque(maxlen=int(marks))  # (p, end, t)
        self._applied: deque = deque(maxlen=int(marks))  # (p, end, t)
        # (version, partition) → sample dict, insertion-ordered and
        # capacity-bounded (oldest evict) — doubles as the
        # already-sampled membership test
        self._samples: OrderedDict[tuple, dict] = OrderedDict()
        # version → keys of samples still awaiting their first serve
        self._awaiting: dict[int, list[tuple]] = {}
        self._lock = threading.Lock()
        self.samples_total = 0
        obs = registry or get_registry()
        self._g_stage = {s: obs.gauge("critical_path_s", stage=s)
                         for s in STAGES}
        self._g_total = obs.gauge("critical_path_total_s")
        self._m_samples = obs.counter("critical_path_samples_total")

    # -- marks ---------------------------------------------------------------

    def note_append(self, end_offset: int, partition: int = 0,
                    t: float | None = None) -> None:
        """Records up to ``end_offset`` of ``partition`` are durably in
        the WAL as of ``t`` — one bounded deque append."""
        with self._lock:
            self._append.append((int(partition), int(end_offset),
                                 time.time() if t is None else float(t)))

    def note_dequeue(self, end_offset: int, partition: int = 0,
                     t: float | None = None) -> None:
        """The batch ending at ``end_offset`` started applying at
        ``t`` — the queue-wait → train-apply boundary."""
        with self._lock:
            self._dequeue.append((int(partition), int(end_offset),
                                  time.time() if t is None else float(t)))

    def note_applied(self, end_offset: int, partition: int = 0,
                     t: float | None = None) -> None:
        """Records up to ``end_offset`` are APPLIED (offset stamped) as
        of ``t``. Pass the same clock read given to
        ``LineageJournal.note_ingest`` so the two planes price the same
        instant."""
        with self._lock:
            self._applied.append((int(partition), int(end_offset),
                                  time.time() if t is None else float(t)))

    # -- sample completion ---------------------------------------------------

    def note_swap(self, version: int, partition: int = 0,
                  watermark: int | None = None,
                  t: float | None = None) -> dict | None:
        """A catalog build (``version``) now covers ``partition`` up to
        ``watermark`` as of ``t`` (pass the lineage record's
        ``wall_time`` — the swap instant — so ``swap_lag`` reconciles
        exactly against the freshness histogram). Completes ONE sample
        per (version, partition): the newest applied record the
        watermark covers. Returns the sample (or None when nothing is
        covered / already sampled)."""
        if watermark is None:
            return None
        version, p = int(version), int(partition)
        w = int(watermark)
        t_swap = time.time() if t is None else float(t)
        key = (version, p)
        with self._lock:
            if key in self._samples:
                return None
            # the sampled record: the newest applied mark the watermark
            # covers — identical to the lineage freshness sampling rule
            applied = None
            for pt, end, tm in self._applied:
                if pt == p and end <= w:
                    if applied is None or (end, tm) > applied:
                        applied = (end, tm)
            if applied is None:
                return None
            end_off, t_applied = applied
            # the apply-start mark of that exact batch (driver batches
            # apply whole, so end offsets match); covering fallback for
            # replayed/coalesced boundaries
            t_dequeue = None
            for pt, end, tm in self._dequeue:
                if pt == p and end == end_off:
                    t_dequeue = tm
            if t_dequeue is None:
                for pt, end, tm in self._dequeue:
                    if pt == p and end >= end_off and t_dequeue is None:
                        t_dequeue = tm
            # the append batch covering the record: the OLDEST append
            # mark whose end reaches it (append ranges are disjoint and
            # ascending per partition)
            t_append = None
            for pt, end, tm in self._append:
                if pt == p and end >= end_off:
                    t_append = tm
                    break
            swap_lag = max(0.0, t_swap - t_applied)
            train_apply = (None if t_dequeue is None
                           else max(0.0, t_applied - t_dequeue))
            queue_wait = (None if t_dequeue is None or t_append is None
                          else max(0.0, t_dequeue - t_append))
            total = t_swap - (t_append if t_append is not None else
                              t_dequeue if t_dequeue is not None else
                              t_applied)
            sample = {
                "catalog_version": version,
                "partition": p,
                "offset": end_off - 1,   # the sampled record's id
                "end_offset": end_off,
                "queue_wait_s": queue_wait,
                "train_apply_s": train_apply,
                "swap_lag_s": swap_lag,
                "flush_wait_s": None,
                "total_s": max(0.0, total),
                "t_swap": t_swap,
                "time": t_swap,
            }
            self._samples[key] = sample
            self._awaiting.setdefault(version, []).append(key)
            while len(self._samples) > self.capacity:
                old_key, _ = self._samples.popitem(last=False)
                keys = self._awaiting.get(old_key[0])
                if keys is not None:
                    keys = [k for k in keys if k != old_key]
                    if keys:
                        self._awaiting[old_key[0]] = keys
                    else:
                        self._awaiting.pop(old_key[0], None)
            self.samples_total += 1
            out = dict(sample)
        self._m_samples.inc()
        self._g_total.set(sample["total_s"])
        for stage in ("queue_wait", "train_apply", "swap_lag"):
            v = sample[f"{stage}_s"]
            if v is not None:
                self._g_stage[stage].set(v)
        return out

    def note_serve(self, version: int, t: float | None = None) -> None:
        """An engine flush served ``version``: the FIRST such flush
        prices the ``flush_wait`` stage of every sample awaiting that
        build. NON-BLOCKING (try-acquire): this runs on the serving
        path — under contention the sample stays awaiting and a later
        flush prices it, rather than serving ever stalling on the
        analyzer lock."""
        if not self._lock.acquire(blocking=False):
            return
        waits = []
        try:
            keys = self._awaiting.pop(int(version), None)
            if not keys:
                return
            now = time.time() if t is None else float(t)
            for key in keys:
                sample = self._samples.get(key)
                if sample is not None and sample["flush_wait_s"] is None:
                    sample["flush_wait_s"] = max(
                        0.0, now - sample["t_swap"])
                    waits.append(sample["flush_wait_s"])
        finally:
            self._lock.release()
        if waits:
            self._g_stage["flush_wait"].set(waits[-1])

    # -- reads ---------------------------------------------------------------

    def samples(self, limit: int | None = None) -> list[dict]:
        """Completed samples, oldest→newest (``limit`` keeps the
        newest)."""
        with self._lock:
            out = [dict(s) for s in self._samples.values()]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def stage_summary(self) -> dict:
        """Per-stage count/mean/max/last over the retained samples —
        the attribution table ``--critical-path`` renders."""
        samples = self.samples()
        out = {}
        for stage in STAGES:
            vals = [s[f"{stage}_s"] for s in samples
                    if s.get(f"{stage}_s") is not None]
            out[stage] = {
                "count": len(vals),
                "mean_s": (sum(vals) / len(vals)) if vals else None,
                "max_s": max(vals) if vals else None,
                "last_s": vals[-1] if vals else None,
            }
        totals = [s["total_s"] for s in samples]
        out["total"] = {
            "count": len(totals),
            "mean_s": (sum(totals) / len(totals)) if totals else None,
            "max_s": max(totals) if totals else None,
            "last_s": totals[-1] if totals else None,
        }
        return out

    def snapshot(self, limit: int = 50) -> dict:
        """The ``/criticalpathz`` body: stage attribution summary +
        the newest completed samples + mark accounting."""
        with self._lock:
            marks = {"append": len(self._append),
                     "dequeue": len(self._dequeue),
                     "applied": len(self._applied)}
        return {
            "time": time.time(),
            "stages": self.stage_summary(),
            "samples": self.samples(limit=limit),
            "samples_total": self.samples_total,
            "capacity": self.capacity,
            "marks": marks,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by
# obs.enable_disttrace
# --------------------------------------------------------------------------

_DISTTRACE: CriticalPathAnalyzer | None = None


def get_disttrace() -> CriticalPathAnalyzer | None:
    """The installed critical-path analyzer or ``None``. Stamping
    components cache this at construction and gate every mark on one
    ``is not None`` test — the same zero-cost discipline as
    ``get_events``/``get_lineage``."""
    return _DISTTRACE


def set_disttrace(analyzer: CriticalPathAnalyzer | None) -> None:
    global _DISTTRACE
    _DISTTRACE = analyzer
