"""Concurrency & saturation observability: lock / queue contention
telemetry and an Amdahl bottleneck attributor (counterpart of
``large_scale_recommendation_tpu.obs.contention``).

The parallel-ingest runtime (``streams/parallel.py``) puts N consumer
threads behind a handful of shared primitives — the model ``apply_lock``,
the ``RowConflictGate`` condition, the checkpoint barrier, the engine
RLock. This module prices wall lost to serialization:

- **instrumented primitives** — ``InstrumentedLock`` / ``InstrumentedRLock``
  / ``InstrumentedCondition`` wrap the named hot locks, publishing per-lock
  ``lock_wait_s{lock=}`` / ``lock_hold_s{lock=}`` histograms,
  ``lock_acquisitions_total`` / ``lock_contended_total`` counters and a
  ``lock_waiters{lock=}`` gauge. The uncontended fast path is one
  ``acquire(blocking=False)`` try. Primitives created under one name share
  one ``LockStats`` row; the table is capped (``max_locks``), overflow
  names get raw ``threading`` primitives, counted.
- **per-thread sampler** — a named-thread registry sampled on the shared
  ``ensure_periodic`` cadence; cross-thread CPU time comes from
  ``time.pthread_getcpuclockid`` + ``clock_gettime`` (Linux), else a
  lock-wait-based estimate (``cpu_source`` says which). Per-thread
  ``thread_cpu_frac{thread=}`` gauges.
- **``SaturationAnalyzer``** — joins lock-wait totals, per-thread CPU
  windows and the per-partition ``streams_*`` gauges into an Amdahl
  decomposition of an N-consumer window: efficiency E = busy thread
  seconds / (N · wall), the Karp–Flatt serial fraction s = (1/E − 1)/(N −
  1), the top contended locks, per-partition blocked share and the
  projected speedup at 2N. Served at ``/contentionz`` (merged pod-wide by
  ``obs.fleet.FleetAggregator.contention``), frozen into bundles
  (``contention.json``), published as ``contention_*`` gauges.

What the numbers mean on the card: a consumer thread blocked in a CUDA
wait (a ``.cpu()`` / ``.item()`` copy, an event or stream synchronize)
spin-waits under the CUDA runtime's default scheduling, so its CPU clock
keeps running and it reads as *busy* here, not blocked: ``efficiency``
counts card waits as parallel work and the Karp–Flatt ``serial_fraction``
understates the serialization the card itself imposes on N consumers that
share it. Read it beside the card's busy share. On a host with fewer cores
than consumers, runnable-but-descheduled threads read as blocked; load
imbalance reads as lost parallel capacity.

Zero-cost when unused: the module default is ``None``
(``get_contention``), the ``named_lock`` / ``named_rlock`` /
``named_condition`` helpers hand back raw ``threading`` primitives when no
tracker is installed, and ``obs.enable_contention()`` installs one.
Components bind at construction, as every other plane.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

from large_scale_recommendation_tpu_torch.obs.registry import get_registry

# the consumer-thread naming convention the analyzer keys partitions on:
# ParallelIngestRunner names its consumer threads "ingest-p<k>"
CONSUMER_THREAD_PATTERN = r"^ingest-p(\d+)$"

_HAS_THREAD_CPU = (hasattr(time, "pthread_getcpuclockid")
                   and hasattr(time, "clock_gettime"))


# --------------------------------------------------------------------------
# Amdahl / Karp–Flatt math (pure — hand-pinned in tests)
# --------------------------------------------------------------------------


def karp_flatt_serial_fraction(efficiency: float | None,
                               n: int) -> float | None:
    """The experimentally-determined serial fraction (Karp–Flatt): with
    measured parallel efficiency E on n workers, Amdahl's law
    ``T(n) = T1·(s + (1−s)/n)`` inverts to ``s = (1/E − 1)/(n − 1)``.
    ``None`` when undefined (n ≤ 1 — one worker prices no parallelism —
    or no positive efficiency measurement); clamped to [0, 1] (sampling
    jitter can push E past 1)."""
    if n <= 1 or efficiency is None or not efficiency > 0:
        return None
    e = min(1.0, float(efficiency))
    s = (1.0 / e - 1.0) / (n - 1.0)
    return min(1.0, max(0.0, s))


def amdahl_speedup(serial_fraction: float, n: int | float) -> float:
    """Amdahl's law: speedup over serial at ``n`` workers with serial
    fraction ``s`` = ``1 / (s + (1−s)/n)``."""
    s = min(1.0, max(0.0, float(serial_fraction)))
    return 1.0 / (s + (1.0 - s) / float(n))


def decompose_window(wall_s: float, consumer_busy: dict,
                     lock_wait_total_s: float,
                     cpu_supported: bool = True) -> dict:
    """The Amdahl decomposition of one N-consumer window — PURE (the
    hand-pinned core ``SaturationAnalyzer`` and the sampler gauges both
    ride): ``consumer_busy`` maps partition → busy (CPU) seconds within
    the ``wall_s`` window. Capacity is N·wall; efficiency is
    busy/capacity; the serial fraction is the Karp–Flatt inversion.
    When per-thread CPU is unsupported, busy is *estimated* as capacity
    minus the lock-wait total (everything not provably blocked counts
    as busy — an optimistic floor, labeled by ``cpu_source``)."""
    n = len(consumer_busy)
    wall_s = max(0.0, float(wall_s))
    capacity = n * wall_s
    if cpu_supported:
        busy = sum(max(0.0, min(wall_s, b))
                   for b in consumer_busy.values())
        cpu_source = "pthread_getcpuclockid"
    else:
        busy = max(0.0, capacity - lock_wait_total_s)
        cpu_source = "lock_wait_fallback"
    efficiency = (busy / capacity) if capacity > 0 else None
    serial = karp_flatt_serial_fraction(efficiency, n)
    out = {
        "consumers": n,
        "wall_s": wall_s,
        "capacity_s": capacity,
        "busy_s": busy,
        "blocked_s": max(0.0, capacity - busy),
        "efficiency": efficiency,
        "serial_fraction": serial,
        "cpu_source": cpu_source,
        "lock_wait_s_total": float(lock_wait_total_s),
    }
    if serial is not None:
        out["speedup_at_n"] = amdahl_speedup(serial, n)
        out["projected_speedup_at_2n"] = amdahl_speedup(serial, 2 * n)
        out["amdahl_limit"] = (1.0 / serial) if serial > 0 else None
    else:
        out["speedup_at_n"] = None
        out["projected_speedup_at_2n"] = None
        out["amdahl_limit"] = None
    return out


# --------------------------------------------------------------------------
# Instrumented primitives
# --------------------------------------------------------------------------


class LockStats:
    """One named lock's shared accounting row. Every primitive created
    under the same name points here, so the per-name totals aggregate
    the lock *class* (e.g. all partitions' ingest queues). Numeric
    fields update under a private raw lock (held for nanoseconds);
    registry instruments carry their own locks and are updated outside
    it."""

    __slots__ = ("name", "kind", "acquisitions", "contended", "reentrant",
                 "cv_waits", "wait_total_s", "hold_total_s", "waiters",
                 "_lock", "_m_wait", "_m_hold", "_m_acq", "_m_contended",
                 "_m_waiters")

    def __init__(self, name: str, kind: str, registry):
        self.name = name
        self.kind = kind
        self.acquisitions = 0
        self.contended = 0
        self.reentrant = 0
        self.cv_waits = 0
        self.wait_total_s = 0.0
        self.hold_total_s = 0.0
        self.waiters = 0
        self._lock = threading.Lock()
        self._m_wait = registry.histogram("lock_wait_s", lock=name)
        self._m_hold = registry.histogram("lock_hold_s", lock=name)
        self._m_acq = registry.counter("lock_acquisitions_total", lock=name)
        self._m_contended = registry.counter("lock_contended_total",
                                             lock=name)
        self._m_waiters = registry.gauge("lock_waiters", lock=name)

    def note_acquired(self, wait_s: float, contended: bool) -> None:
        with self._lock:
            self.acquisitions += 1
            if contended:
                self.contended += 1
                self.wait_total_s += wait_s
        self._m_acq.inc()
        if contended:
            self._m_contended.inc()
            self._m_wait.observe(wait_s)

    def note_wait(self, wait_s: float, cv: bool = False) -> None:
        """Blocked time that did not end in a fresh acquisition (an
        acquire timeout, or a condition ``wait()`` — the lock was
        already held)."""
        with self._lock:
            self.wait_total_s += wait_s
            if cv:
                self.cv_waits += 1
            else:
                self.contended += 1
        self._m_wait.observe(wait_s)

    def note_reentrant(self) -> None:
        with self._lock:
            self.reentrant += 1

    def note_hold(self, hold_s: float) -> None:
        with self._lock:
            self.hold_total_s += hold_s
        self._m_hold.observe(hold_s)

    def waiter_enter(self) -> None:
        with self._lock:
            self.waiters += 1
        self._m_waiters.add(1)

    def waiter_exit(self) -> None:
        with self._lock:
            self.waiters -= 1
        self._m_waiters.add(-1)

    def snapshot(self) -> dict:
        with self._lock:
            return {"lock": self.name, "kind": self.kind,
                    "acquisitions": self.acquisitions,
                    "contended": self.contended,
                    "reentrant": self.reentrant,
                    "cv_waits": self.cv_waits,
                    "wait_s": self.wait_total_s,
                    "hold_s": self.hold_total_s,
                    "waiters": self.waiters}


class _InstrumentedBase:
    """Shared acquire/release timing for the three primitive kinds.

    The fast path is ``acquire(blocking=False)`` on the inner primitive:
    an uncontended acquisition records only the counter bump (no wait
    clock read). A blocked acquisition stamps the waiters gauge and the
    wait wall. Holds are stamped per owning thread (``_hold_t0``) and
    observed on the final release; RLock reentrancy tracks per-thread
    depth so nested acquires never double-count waits or holds (pinned).
    Each thread only ever touches its own ``_hold_t0``/``_depth`` keys,
    so the dicts need no extra lock (CPython dict ops are GIL-atomic).
    """

    def __init__(self, inner, stats: LockStats):
        self._inner = inner
        self._stats = stats
        self._hold_t0: dict[int, float] = {}
        self._depth: dict[int, int] = {}

    @property
    def name(self) -> str:
        return self._stats.name

    @property
    def stats(self) -> LockStats:
        return self._stats

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ident = threading.get_ident()
        if self._depth.get(ident, 0):
            # reentrant re-acquire (RLock / Condition's inner RLock):
            # succeeds immediately for the owner, no wait/hold stamps
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._depth[ident] += 1
                self._stats.note_reentrant()
            return ok
        if self._inner.acquire(blocking=False):
            self._note_acquired(ident, 0.0, contended=False)
            return True
        if not blocking:
            return False
        s = self._stats
        s.waiter_enter()
        t0 = time.perf_counter()
        try:
            ok = self._inner.acquire(True, timeout)
        finally:
            wait = time.perf_counter() - t0
            s.waiter_exit()
        if ok:
            self._note_acquired(ident, wait, contended=True)
        else:
            s.note_wait(wait)  # timed out: blocked time with no lock
        return ok

    def _note_acquired(self, ident: int, wait: float,
                       contended: bool) -> None:
        self._depth[ident] = 1
        self._hold_t0[ident] = time.perf_counter()
        self._stats.note_acquired(wait, contended)

    def release(self) -> None:
        ident = threading.get_ident()
        if self._depth.get(ident, 0) > 1:
            self._depth[ident] -= 1
            self._inner.release()
            return
        t0 = self._hold_t0.pop(ident, None)
        self._depth.pop(ident, None)
        self._inner.release()
        if t0 is not None:
            self._stats.note_hold(time.perf_counter() - t0)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()


class InstrumentedLock(_InstrumentedBase):
    """A ``threading.Lock`` with wait/hold/contention accounting. Same
    semantics as the raw primitive (including NOT being reentrant — an
    owner re-acquiring deadlocks exactly like a raw Lock)."""

    def __init__(self, stats: LockStats):
        super().__init__(threading.Lock(), stats)

    def locked(self) -> bool:
        return self._inner.locked()


class InstrumentedRLock(_InstrumentedBase):
    """A ``threading.RLock`` with accounting: only the OUTERMOST
    acquire/release pair records a wait and a hold — reentrant
    re-acquisitions bump ``reentrant`` and nothing else (pinned:
    reentrancy never double-counts)."""

    def __init__(self, stats: LockStats):
        super().__init__(threading.RLock(), stats)


class InstrumentedCondition(_InstrumentedBase):
    """A ``threading.Condition`` with accounting. ``wait()`` is the
    interesting path: the lock is RELEASED while waiting, so the
    current hold segment is closed before the wait, the blocked time
    records into the same ``lock_wait_s`` histogram (it is time stolen
    by that named primitive — exactly what the Amdahl analyzer prices,
    counted separately as ``cv_waits``), and the hold clock restarts on
    wake — hold histograms never include time spent waiting."""

    def __init__(self, stats: LockStats):
        super().__init__(threading.Condition(), stats)

    def wait(self, timeout: float | None = None) -> bool:
        ident = threading.get_ident()
        t_wait = time.perf_counter()
        t0 = self._hold_t0.pop(ident, None)
        if t0 is not None:
            self._stats.note_hold(t_wait - t0)
        self._stats.waiter_enter()
        try:
            notified = self._inner.wait(timeout)
        finally:
            t_wake = time.perf_counter()
            self._stats.waiter_exit()
            self._stats.note_wait(t_wake - t_wait, cv=True)
            self._hold_t0[ident] = t_wake
        return notified

    def wait_for(self, predicate, timeout: float | None = None):
        # built on the instrumented wait() so every blocked stretch is
        # priced — mirrors threading.Condition.wait_for
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# --------------------------------------------------------------------------
# The tracker: named-lock table + thread sampler + measurement window
# --------------------------------------------------------------------------


class _ThreadEntry:
    __slots__ = ("ident", "name", "thread", "clock_id", "supported",
                 "cpu_s", "base_cpu_s", "last_tick_cpu", "last_tick_t",
                 "first_seen", "last_seen", "alive")

    def __init__(self, thread: threading.Thread, now: float):
        self.ident = thread.ident
        self.name = thread.name
        self.thread = thread
        self.supported = False
        self.clock_id = None
        if _HAS_THREAD_CPU:
            try:
                self.clock_id = time.pthread_getcpuclockid(thread.ident)
                self.supported = True
            except (AttributeError, ValueError, OSError, OverflowError):
                pass
        self.cpu_s = 0.0
        self.base_cpu_s = 0.0  # window baseline (reset_window rebases)
        self.last_tick_cpu = 0.0
        self.last_tick_t = now
        self.first_seen = now
        self.last_seen = now
        self.alive = True

    def read_cpu(self) -> bool:
        if not self.supported:
            return False
        try:
            self.cpu_s = time.clock_gettime(self.clock_id)
            return True
        except OSError:  # thread exited, clock id retired — keep the
            return False  # last sampled total


class ContentionTracker:
    """The concurrency plane's state: the named-lock stats table, the
    thread sampler, and the measurement window the analyzer decomposes.

    ``lock(name)`` / ``rlock(name)`` / ``condition(name)`` mint
    instrumented primitives sharing the per-name stats row; the table
    is hard-capped at ``max_locks`` (overflow names get raw primitives,
    counted in ``locks_dropped`` — bounded tables, the obs rule). The
    sampler (``start()``/``sample_threads()``, the shared
    ``ensure_periodic`` cadence) tracks every live thread's CPU clock,
    bounded at ``max_threads``, and publishes ``thread_cpu_frac{thread=}``
    per tick plus the ``contention_*`` window gauges the flight
    recorder keeps history for. ``reset_window()`` re-anchors the
    measurement window (the bench resets per scaling rung)."""

    def __init__(self, registry=None, max_locks: int = 256,
                 max_threads: int = 128,
                 consumer_pattern: str = CONSUMER_THREAD_PATTERN):
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._stats: dict[str, LockStats] = {}
        self.locks_dropped = 0
        self.max_locks = int(max_locks)
        self.max_threads = int(max_threads)
        self.consumer_pattern = consumer_pattern
        self._consumer_re = re.compile(consumer_pattern)
        self._threads: dict[int, _ThreadEntry] = {}
        self._finished: deque[_ThreadEntry] = deque(maxlen=int(max_threads))
        self.threads_dropped = 0
        self.cpu_supported = _HAS_THREAD_CPU
        self._task = None
        self.window_start = time.time()
        self._window_t0 = time.perf_counter()
        # per-lock window baselines: name -> (acq, contended, wait, hold)
        self._lock_base: dict[str, tuple] = {}
        self._g_wait_total = self._registry.gauge(
            "contention_lock_wait_s_total")
        self._g_serial = self._registry.gauge("contention_serial_fraction")
        self._g_consumers = self._registry.gauge("contention_consumers")
        self._g_threads = self._registry.gauge("contention_threads_tracked")

    # -- named-lock factory --------------------------------------------------

    def _stats_for(self, name: str, kind: str) -> LockStats | None:
        with self._lock:
            stats = self._stats.get(name)
            if stats is None:
                if len(self._stats) >= self.max_locks:
                    self.locks_dropped += 1
                    return None
                stats = self._stats[name] = LockStats(name, kind,
                                                      self._registry)
            return stats

    def lock(self, name: str):
        stats = self._stats_for(name, "lock")
        return threading.Lock() if stats is None else \
            InstrumentedLock(stats)

    def rlock(self, name: str):
        stats = self._stats_for(name, "rlock")
        return threading.RLock() if stats is None else \
            InstrumentedRLock(stats)

    def condition(self, name: str):
        stats = self._stats_for(name, "condition")
        return threading.Condition() if stats is None else \
            InstrumentedCondition(stats)

    def lock_names(self) -> list[str]:
        with self._lock:
            return sorted(self._stats)

    # -- the measurement window ----------------------------------------------

    def reset_window(self) -> None:
        """Re-anchor the Amdahl window: lock totals and thread CPU
        clocks rebase to now, finished-thread history from the previous
        window is dropped. (The bench calls this before each timed
        scaling rung.)"""
        self.sample_threads()
        with self._lock:
            self.window_start = time.time()
            self._window_t0 = time.perf_counter()
            self._lock_base = {
                name: (s.acquisitions, s.contended, s.wait_total_s,
                       s.hold_total_s, s.reentrant, s.cv_waits)
                for name, s in self._stats.items()
            }
            self._finished.clear()
            for entry in self._threads.values():
                entry.base_cpu_s = entry.cpu_s

    def window_wall_s(self) -> float:
        return time.perf_counter() - self._window_t0

    def lock_window(self) -> list[dict]:
        """Per-lock deltas since the window anchor, contended-first
        (wait desc, then acquisitions desc)."""
        with self._lock:
            rows = []
            for name, s in self._stats.items():
                snap = s.snapshot()
                base = self._lock_base.get(name,
                                           (0, 0, 0.0, 0.0, 0, 0))
                snap["acquisitions"] -= base[0]
                snap["contended"] -= base[1]
                snap["wait_s"] = max(0.0, snap["wait_s"] - base[2])
                snap["hold_s"] = max(0.0, snap["hold_s"] - base[3])
                snap["reentrant"] -= base[4]
                snap["cv_waits"] -= base[5]
                rows.append(snap)
        rows.sort(key=lambda r: (-r["wait_s"], -r["acquisitions"]))
        return rows

    def thread_window(self) -> list[dict]:
        """Per-thread window CPU: every entry seen within the current
        window (live + finished), busy = cpu_s − window base."""
        with self._lock:
            entries = list(self._threads.values()) + list(self._finished)
            out = []
            for e in entries:
                if e.last_seen < self.window_start:
                    continue  # died before this window opened
                out.append({"thread": e.name, "ident": e.ident,
                            "alive": e.alive,
                            "supported": e.supported,
                            "cpu_s": max(0.0, e.cpu_s - e.base_cpu_s)})
        out.sort(key=lambda r: -r["cpu_s"])
        return out

    def consumer_busy(self, thread_rows: list[dict] | None = None,
                      ) -> dict[int, dict]:
        """Partition → {thread, busy_s} for threads matching the
        consumer pattern within the window (multiple generations of the
        same partition thread sum). Pass ``thread_rows`` to reuse one
        consistent ``thread_window()`` read — a caller assembling a
        whole snapshot must not re-read the table per field (the reads
        would be DIFFERENT snapshots, and a consumer exiting between
        them breaks the busy-sum reconciliation)."""
        out: dict[int, dict] = {}
        rows = (self.thread_window() if thread_rows is None
                else thread_rows)
        for row in rows:
            m = self._consumer_re.match(row["thread"])
            if m is None:
                continue
            p = int(m.group(1))
            slot = out.setdefault(p, {"thread": row["thread"],
                                      "busy_s": 0.0})
            slot["busy_s"] += row["cpu_s"]
        return out

    def window_summary(self, thread_rows: list[dict] | None = None,
                       lock_rows: list[dict] | None = None) -> dict:
        """The cheap Amdahl core over the current window (no registry
        reads): ``decompose_window`` over the consumer threads + the
        lock-wait total. The sampler tick publishes gauges from this;
        the analyzer snapshot adds the registry joins on top, passing
        the table reads it already took so every field of one snapshot
        reflects ONE consistent view."""
        wall = self.window_wall_s()
        consumers = self.consumer_busy(thread_rows)
        if lock_rows is None:
            lock_rows = self.lock_window()
        wait_total = sum(r["wait_s"] for r in lock_rows)
        core = decompose_window(
            wall, {p: c["busy_s"] for p, c in consumers.items()},
            wait_total, cpu_supported=self.cpu_supported)
        core["window_start"] = self.window_start
        core["consumer_threads"] = {p: c["thread"]
                                    for p, c in consumers.items()}
        return core

    # -- the named-thread registry -------------------------------------------

    def note_thread_start(self) -> None:
        """Check the CURRENT thread into the registry. The sampler
        discovers long-running threads on its own cadence; a
        short-lived worker (a scaling rung's consumer draining in tens
        of milliseconds) can be born and gone between two ticks, so
        thread-spawning runtimes (``ParallelIngestRunner``) check their
        workers in at spawn and out at exit — one ``is not None`` test
        per thread lifetime, not per batch."""
        th = threading.current_thread()
        if th.ident is None:
            return
        now = time.time()
        with self._lock:
            entry = self._threads.get(th.ident)
            if entry is not None and entry.thread is not th:
                entry.alive = False
                self._finished.append(entry)
                entry = None
            if entry is None:
                if (len(self._threads) + len(self._finished)
                        >= self.max_threads):
                    self.threads_dropped += 1
                    return
                self._threads[th.ident] = _ThreadEntry(th, now)

    def note_thread_end(self) -> None:
        """Stamp the CURRENT thread's final CPU total on its way out —
        ``time.thread_time()`` reads the calling thread exactly (the
        same clock basis as the sampler's ``pthread_getcpuclockid``
        reads), so a worker that never survived a sampler tick still
        prices its busy time."""
        th = threading.current_thread()
        with self._lock:
            entry = self._threads.get(th.ident)
            if entry is None or entry.thread is not th:
                return
            try:
                entry.cpu_s = max(entry.cpu_s, time.thread_time())
            except (AttributeError, OSError):
                pass
            entry.last_seen = time.time()

    # -- the thread sampler --------------------------------------------------

    def sample_threads(self) -> int:
        """One sampler tick: refresh every live thread's CPU clock
        (bounded table), archive finished threads, publish the
        per-thread utilization gauges + the ``contention_*`` window
        gauges. Returns the number of live threads tracked."""
        now = time.time()
        gauges = []
        with self._lock:
            live: set[int] = set()
            for th in threading.enumerate():
                ident = th.ident
                if ident is None:
                    continue
                entry = self._threads.get(ident)
                if entry is not None and entry.thread is not th:
                    # ident reuse across thread generations: archive
                    # the dead entry, start a fresh one (its CPU clock
                    # id belongs to the OLD pthread)
                    entry.alive = False
                    self._finished.append(entry)
                    entry = None
                if entry is None:
                    if (len(self._threads) + len(self._finished)
                            >= self.max_threads):
                        self.threads_dropped += 1
                        continue
                    entry = self._threads[ident] = _ThreadEntry(th, now)
                entry.read_cpu()
                entry.last_seen = now
                live.add(ident)
                dt = now - entry.last_tick_t
                if dt > 0 and entry.supported:
                    frac = (entry.cpu_s - entry.last_tick_cpu) / dt
                    gauges.append((entry.name, min(1.0, max(0.0, frac))))
                entry.last_tick_cpu = entry.cpu_s
                entry.last_tick_t = now
            for ident in [i for i in self._threads if i not in live]:
                entry = self._threads.pop(ident)
                entry.alive = False
                self._finished.append(entry)
            tracked = len(self._threads)
        for name, frac in gauges:
            self._registry.gauge("thread_cpu_frac", thread=name).set(frac)
        core = self.window_summary()
        self._g_wait_total.set(core["lock_wait_s_total"])
        # an undefined estimate (no consumers in window / N=1) resets
        # the gauge to 0 rather than leaving the PREVIOUS window's
        # value frozen in the recorder history as if still measured;
        # contention_consumers is the disambiguator (serial_fraction
        # series are meaningful only where consumers >= 2)
        self._g_serial.set(core["serial_fraction"] or 0.0)
        self._g_consumers.set(core["consumers"])
        self._g_threads.set(tracked)
        return tracked

    # -- cadence (shared PeriodicTask machinery) -----------------------------

    def start(self, interval_s: float = 1.0) -> "ContentionTracker":
        from large_scale_recommendation_tpu_torch.obs.health import ensure_periodic

        self._task = ensure_periodic(self._task, self.sample_threads,
                                     interval_s, name="contention-sampler")
        return self

    def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.stop()

    @property
    def running(self) -> bool:
        return self._task is not None and self._task.running


# --------------------------------------------------------------------------
# The saturation analyzer (the /contentionz body)
# --------------------------------------------------------------------------


class SaturationAnalyzer:
    """Joins the tracker's Amdahl core with the per-partition
    ``streams_*`` registry gauges into the ``/contentionz`` document:
    the window decomposition (efficiency, Karp–Flatt serial fraction,
    projected speedup at 2N), the top-k contended locks, and one row
    per consumer partition (busy/blocked split + its
    records/lag/queue-depth gauges)."""

    def __init__(self, contention: ContentionTracker, registry=None,
                 top_k: int = 8):
        self.contention = contention
        self._registry = registry or contention._registry
        self.top_k = int(top_k)

    def _streams_by_partition(self) -> dict[str, dict]:
        """{partition: {records_total, lag_records, queue_depth}} from
        the registry's per-partition ``streams_*`` instruments (empty
        under the null registry)."""
        out: dict[str, dict] = {}
        joins = (("streams_records_total", "records_total"),
                 ("streams_lag_records", "lag_records"),
                 ("streams_queue_depth", "queue_depth"))
        for metric, field in joins:
            for inst in self._registry.find(metric):
                labels = dict(inst.labels)
                part = labels.get("partition")
                if part is None:
                    continue
                out.setdefault(part, {})[field] = inst.value
        return out

    def snapshot(self) -> dict:
        tracker = self.contention
        tracker.sample_threads()  # refresh live CPU clocks first
        # ONE read of each table, reused for every field below: the
        # aggregate decomposition, the per-partition rows and the
        # threads list must all reflect the SAME instant (a consumer
        # exiting between two reads would break the busy-sum
        # reconciliation the acceptance test pins)
        thread_rows = tracker.thread_window()
        lock_rows = tracker.lock_window()
        core = tracker.window_summary(thread_rows=thread_rows,
                                      lock_rows=lock_rows)
        consumers = tracker.consumer_busy(thread_rows)
        active = [r for r in lock_rows
                  if r["acquisitions"] > 0 or r["wait_s"] > 0]
        streams = self._streams_by_partition()
        capacity = core["capacity_s"]
        wall = core["wall_s"]
        partitions = {}
        for p, slot in sorted(consumers.items()):
            # clamped to the window wall exactly like the aggregate
            # (decompose_window), so per-partition busy sums to busy_s
            busy = max(0.0, min(wall, slot["busy_s"]))
            partitions[str(p)] = {
                "thread": slot["thread"],
                "busy_s": busy,
                "blocked_s": max(0.0, wall - busy),
                "blocked_frac": (max(0.0, 1.0 - busy / wall)
                                 if wall > 0 else None),
                **streams.get(str(p), {}),
            }
        for row in active:
            row["wait_frac_of_capacity"] = (
                row["wait_s"] / capacity if capacity > 0 else None)
        return {
            "time": time.time(),
            "window": {"start": core["window_start"],
                       "wall_s": core["wall_s"]},
            "consumers": core["consumers"],
            "capacity_s": capacity,
            "busy_s": core["busy_s"],
            "blocked_s": core["blocked_s"],
            "efficiency": core["efficiency"],
            "serial_fraction": core["serial_fraction"],
            "speedup_at_n": core["speedup_at_n"],
            "projected_speedup_at_2n": core["projected_speedup_at_2n"],
            "amdahl_limit": core["amdahl_limit"],
            "cpu_source": core["cpu_source"],
            "lock_wait_s_total": core["lock_wait_s_total"],
            "locks": active,
            "top_contended": active[:self.top_k],
            "partitions": partitions,
            "threads": thread_rows,
            "locks_tracked": len(lock_rows),
            "locks_dropped": tracker.locks_dropped,
            "threads_dropped": tracker.threads_dropped,
        }


# --------------------------------------------------------------------------
# Module-level default (None = zero cost) + the named-primitive helpers
# --------------------------------------------------------------------------

_CONTENTION: ContentionTracker | None = None


def get_contention() -> ContentionTracker | None:
    """The installed contention tracker or ``None``. Lock-owning
    components resolve this at construction through the ``named_*``
    helpers below — the same bind-at-construction rule as every other
    plane."""
    return _CONTENTION


def set_contention(tracker: ContentionTracker | None) -> None:
    global _CONTENTION
    _CONTENTION = tracker


def named_lock(name: str):
    """A ``threading.Lock`` — RAW when no tracker is installed (the
    zero-cost default: no wrapper object, no stats row, zero clock
    reads), instrumented under ``name`` when one is."""
    tracker = get_contention()
    return threading.Lock() if tracker is None else tracker.lock(name)


def named_rlock(name: str):
    """``named_lock``'s reentrant twin."""
    tracker = get_contention()
    return threading.RLock() if tracker is None else tracker.rlock(name)


def named_condition(name: str):
    """``named_lock``'s condition-variable twin (``wait()`` time is
    priced as blocked time on the named primitive)."""
    tracker = get_contention()
    return (threading.Condition() if tracker is None
            else tracker.condition(name))
