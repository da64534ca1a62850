"""TRANSFER observability plane: the host↔device boundary, measured
(counterpart of ``large_scale_recommendation_tpu.obs.transfers``).

Three instruments behind the module-default-``None`` getter
(``get_transfers()`` answers ``None`` until ``obs.enable_transfers()``
installs a ``TransferLedger``; ``obs.disable()`` clears it; every consumer
pays one ``is not None`` test):

- **Named-site ledger** — ``note_transfer(site, direction, nbytes,
  seconds)`` at every deliberate crossing (checkpoint snapshot pulls and
  restore pushes), publishing ``transfer_bytes_total{site,dir}`` counters
  and ``transfer_wait_s{site}`` histograms plus a per-site effective
  GB/s. Bytes are LOGICAL ``rows × rank × itemsize``.

- **Implicit-transfer guard** — ``guard(site)`` scopes
  ``torch.cuda.set_sync_debug_mode`` around a hot path (the counterpart
  of ``jax.transfer_guard``): an operation that makes the host wait on
  the card without being asked (``.item()``, ``int(t)``, a blocking
  copy to the host, ``nonzero``) is a synchronizing operation. Modes:
  ``off`` (the default: a shared null context, zero allocations),
  ``log`` (sync-debug ``"warn"``: each such operation is counted into
  ``implicit_transfers_total{site}``, its stack written to stderr once
  per site, and the work goes on) and ``disallow`` (``"error"``: the
  operation raises; it is counted, its stack logged once per site, and
  re-raised). ``allow(site)`` opens a deliberate-crossing window inside
  an armed scope (mode 0 until it closes).

  Two documented differences from the JAX guard. The sync-debug mode is
  PROCESS-global, where ``jax.transfer_guard`` is thread-local: while
  any scope is armed, a synchronizing operation on ANY thread warns (or,
  under ``disallow``, raises) — the ledger attributes it to the
  innermost scope open on the calling thread, else to the site
  ``"<other-thread>"``. Scopes nest and overlap across threads through a
  depth count under a lock: the first armed scope to open sets the mode,
  the last to close puts back 0, and an ``allow`` window holds the mode
  at 0 for every thread while it is open. On the CPU no operation
  synchronizes and torch has no sync-debug mode to set: the scopes keep
  their accounting and change nothing.

- **Retrace watch** — ``watch(name, obj)`` registers any object with a
  ``_cache_size()`` (a jitted function in the JAX package); the port has
  no trace cache, and ``enable_transfers(watch_hot=True)`` watches the
  kernel loader's per-library build and load counts
  (``ops._build.LibraryWatch``), so a rebuild or reload after
  ``mark_steady()`` counts as ``retrace_total{fn=}``.
  ``HealthMonitor.watch_transfers`` gates on the steady-state window.
"""

from __future__ import annotations

import re
import sys
import threading
import time
import traceback
import warnings
from collections import deque

import torch

from large_scale_recommendation_tpu_torch.obs.registry import get_registry

H2D = "h2d"
D2H = "d2h"

GUARD_MODES = ("off", "log", "disallow")


class _NullContext:
    """Shared no-op context manager: the unarmed guard path and the
    absent-plane path both hand out THIS one object — no allocations,
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


# torch's message for a synchronizing operation under sync-debug mode
_SYNC_MESSAGE = "called a synchronizing CUDA operation"
OTHER_THREAD = "<other-thread>"


def _is_transfer_violation(exc: BaseException) -> bool:
    """Whether ``exc`` is a sync-debug ``"error"`` trip (matched on
    torch's message; anything else propagates un-attributed)."""
    return _SYNC_MESSAGE in str(exc)


def _set_sync_debug_mode(mode: int) -> None:
    """The process's sync-debug mode (0 off, 1 warn, 2 error); torch has
    none to set without a card."""
    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(mode)


class _SyncDebug:
    """The process-global sync-debug state shared by every ledger's
    scopes: how many armed scopes and allow windows are open (over all
    threads), the mode the open scopes asked for, the warning hook that
    counts ``log`` trips, and each thread's stack of open sites."""

    def __init__(self):
        self.lock = threading.Lock()
        self.armed = 0  # open armed scopes, all threads
        self.allowed = 0  # open allow windows, all threads
        self.mode = 0  # the open scopes' mode (1 warn, 2 error)
        self.local = threading.local()
        self._prev_show = None
        self._filter = None

    def sites(self) -> list:
        stack = getattr(self.local, "sites", None)
        if stack is None:
            stack = self.local.sites = []
        return stack

    def _apply_locked(self) -> None:
        _set_sync_debug_mode(0 if self.allowed or not self.armed
                             else self.mode)

    def enter(self, ledger, site: str, mode: int) -> None:
        self.sites().append((ledger, site))
        with self.lock:
            if self.armed == 0:
                self.mode = mode
                if mode == 1:
                    self._hook_warnings_locked()
            self.armed += 1
            self._apply_locked()

    def exit(self) -> None:
        stack = self.sites()
        if stack:
            stack.pop()
        with self.lock:
            self.armed -= 1
            if self.armed == 0:
                self._unhook_warnings_locked()
                self.mode = 0
            self._apply_locked()

    def allow(self, delta: int) -> None:
        with self.lock:
            self.allowed += delta
            self._apply_locked()

    def _hook_warnings_locked(self) -> None:
        # every sync warning reaches showwarning (a "default" filter would
        # show one per call site), which counts it and hands the rest on
        warnings.filterwarnings("always", message=re.escape(_SYNC_MESSAGE))
        self._filter = warnings.filters[0]
        self._prev_show = warnings.showwarning
        prev = self._prev_show

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if _SYNC_MESSAGE in str(message):
                stack = self.sites()
                ledger, site = (stack[-1] if stack
                                else (get_transfers(), OTHER_THREAD))
                if ledger is not None:
                    ledger._record_implicit(site, None, None, None,
                                            where=f"{filename}:{lineno}")
                return
            prev(message, category, filename, lineno, file, line)

        warnings.showwarning = show

    def _unhook_warnings_locked(self) -> None:
        if self._prev_show is not None:
            warnings.showwarning = self._prev_show
            self._prev_show = None
        if self._filter in warnings.filters:
            warnings.filters.remove(self._filter)
            warnings._filters_mutated()
        self._filter = None


_SYNC = _SyncDebug()


def arg_signature(a) -> str:
    """A cheap, human-readable trace-relevant signature of one
    argument: ``dtype[shape]`` for anything array-like, a truncated
    ``repr`` for static values. No device sync, no data read."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{dtype}[{','.join(str(d) for d in shape)}]"
    r = repr(a)
    return r if len(r) <= 48 else r[:45] + "..."


class _Site:
    """One named crossing's running totals + its bound instruments."""

    __slots__ = ("h2d_bytes", "d2h_bytes", "h2d_count", "d2h_count",
                 "wait_s", "c_h2d", "c_d2h", "h_wait")

    def __init__(self, name: str, registry):
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_count = 0
        self.d2h_count = 0
        self.wait_s = 0.0
        self.c_h2d = registry.counter("transfer_bytes_total",
                                      site=name, dir=H2D)
        self.c_d2h = registry.counter("transfer_bytes_total",
                                      site=name, dir=D2H)
        self.h_wait = registry.histogram("transfer_wait_s", site=name)

    def effective_gbs(self) -> float | None:
        """Measured bytes-over-wait for this site, or ``None`` before
        any timed transfer landed."""
        if self.wait_s <= 0.0:
            return None
        return (self.h2d_bytes + self.d2h_bytes) / self.wait_s / 1e9


class _GuardScope:
    """An armed guard scope: raises the process's sync-debug mode while
    open (``log`` → warn, ``disallow`` → error, see ``_SyncDebug``), and
    on the way out attributes a ``disallow`` trip to the site — count,
    log-once the stack, re-raise (a trip aborts the body; it cannot be
    swallowed and continued)."""

    __slots__ = ("_ledger", "_site", "_mode")

    def __init__(self, ledger: "TransferLedger", site: str, mode: int):
        self._ledger = ledger
        self._site = site
        self._mode = mode

    def __enter__(self):
        _SYNC.enter(self._ledger, self._site, self._mode)
        return None

    def __exit__(self, exc_type, exc, tb):
        _SYNC.exit()
        if exc is not None and _is_transfer_violation(exc):
            self._ledger._record_implicit(self._site, exc_type, exc, tb)
        return False


class _AllowScope:
    """A deliberate-crossing window: sync-debug mode 0 while open."""

    __slots__ = ()

    def __enter__(self):
        _SYNC.allow(1)
        return None

    def __exit__(self, exc_type, exc, tb):
        _SYNC.allow(-1)
        return False


_ALLOW = _AllowScope()


class TransferLedger:
    """Per-site device↔host transfer ledger + implicit-transfer guard
    + retrace watch. Thread-safe: seam sites note transfers from
    worker threads while a reader snapshots.

    ``guard_mode`` arms every ``guard(site)`` scope at once —
    ``\"off\"`` in production (zero cost), ``\"disallow\"`` in
    debug/CI. ``ring_capacity`` bounds the retrace-diff ring.
    """

    def __init__(self, guard_mode: str = "off", ring_capacity: int = 64,
                 registry=None):
        if guard_mode not in GUARD_MODES:
            raise ValueError(f"guard_mode must be one of {GUARD_MODES}, "
                             f"got {guard_mode!r}")
        self.guard_mode = guard_mode
        self._lock = threading.Lock()
        self._obs = registry or get_registry()
        self._sites: dict[str, _Site] = {}
        # implicit-transfer attribution
        self._implicit: dict[str, int] = {}
        self._implicit_total = 0
        self._implicit_logged: set[str] = set()
        # retrace watch
        self._watched: dict[str, object] = {}      # name -> watched object
        self._trace_counts: dict[str, int] = {}    # name -> last count
        self._retraces: dict[str, int] = {}        # name -> retraces seen
        self._sig_prev: dict[str, tuple] = {}
        self._sig_cur: dict[str, tuple] = {}
        self._ring: deque = deque(maxlen=ring_capacity)
        # steady-state window (HealthMonitor.watch_transfers gates on it)
        self._steady_marked = False
        self._steady_retraces = 0
        self._steady_implicit = 0

    # -- named-site ledger --------------------------------------------------

    def note_transfer(self, site: str, direction: str, nbytes: int,
                      seconds: float = 0.0) -> None:
        """Record one deliberate boundary crossing at ``site``:
        ``direction`` is ``\"h2d\"`` or ``\"d2h\"``, ``nbytes`` the
        LOGICAL payload (rows × rank × itemsize — not pow2-padded),
        ``seconds`` the measured wall the caller waited on it (0.0
        when the crossing rides an async dispatch the caller didn't
        block on)."""
        if direction not in (H2D, D2H):
            raise ValueError(f"direction must be {H2D!r} or {D2H!r}, "
                             f"got {direction!r}")
        nbytes = int(nbytes)
        seconds = float(seconds)
        with self._lock:
            s = self._sites.get(site)
            if s is None:
                s = self._sites[site] = _Site(site, self._obs)
            if direction == H2D:
                s.h2d_bytes += nbytes
                s.h2d_count += 1
                c = s.c_h2d
            else:
                s.d2h_bytes += nbytes
                s.d2h_count += 1
                c = s.c_d2h
            s.wait_s += seconds
            h = s.h_wait
        c.inc(nbytes)       # instruments carry their own locks
        h.observe(seconds)

    def site_gbs(self) -> dict[str, float]:
        """Per-site measured effective GB/s (bytes over waited
        seconds), only for sites that recorded a nonzero wait — the
        ``/rooflinez`` join key."""
        with self._lock:
            sites = list(self._sites.items())
        out = {}
        for name, s in sites:
            gbs = s.effective_gbs()
            if gbs is not None:
                out[name] = gbs
        return out

    # -- implicit-transfer guard --------------------------------------------

    def guard(self, site: str):
        """A scoped sync-debug guard for one hot path, attributing
        synchronizing operations to ``site``. Mode ``off`` returns the
        shared null context (zero cost); ``log`` counts and goes on;
        ``disallow`` raises, counts, log-onces and re-raises."""
        mode = self.guard_mode
        if mode == "off":
            return _NULL_CONTEXT
        return _GuardScope(self, site, 1 if mode == "log" else 2)

    def allow(self, site: str):
        """A deliberate-crossing window inside an armed scope (mode 0
        while it is open, for every thread: the mode is process-global).
        Null context when the guard is off."""
        if self.guard_mode == "off":
            return _NULL_CONTEXT
        return _ALLOW

    def _record_implicit(self, site: str, exc_type, exc, tb,
                         where: str | None = None) -> None:
        with self._lock:
            self._implicit[site] = self._implicit.get(site, 0) + 1
            self._implicit_total += 1
            if self._steady_marked:
                self._steady_implicit += 1
            first = site not in self._implicit_logged
            self._implicit_logged.add(site)
        self._obs.counter("implicit_transfers_total", site=site).inc()
        if first:  # log-once per site: the stack names the exact line
            stack = ("".join(traceback.format_exception(exc_type, exc, tb))
                     if exc is not None
                     else "".join(traceback.format_stack(limit=12))
                     + f"(warned at {where})\n")
            sys.stderr.write(f"[obs.transfers] implicit transfer at site "
                             f"{site!r} (stack logged once per site):\n"
                             f"{stack}")

    @property
    def implicit_total(self) -> int:
        with self._lock:
            return self._implicit_total

    # -- retrace watch ------------------------------------------------------

    @staticmethod
    def _cache_size(fn) -> int | None:
        """``fn._cache_size()`` (a library's build and load count, for
        ``ops._build.LibraryWatch``), or ``None`` when ``fn`` has none."""
        probe = getattr(fn, "_cache_size", None)
        if probe is None:
            return None
        try:
            return int(probe())
        except Exception:
            return None

    def watch(self, name: str, fn) -> None:
        """Register an object with ``_cache_size()`` for retrace
        watching; the current count becomes the baseline (builds and
        loads so far are not retraces)."""
        size = self._cache_size(fn)
        with self._lock:
            self._watched[name] = fn
            if size is not None:
                self._trace_counts[name] = size
            self._retraces.setdefault(name, 0)

    def watched(self) -> list[str]:
        with self._lock:
            return sorted(self._watched)

    def observe_call(self, name: str, *args, **kwargs) -> None:
        """Record a cheap signature (shape/dtype per array arg, repr
        per static) for watched fn ``name``; when a retrace lands, the
        ring diff names which arg changed vs the previous call."""
        sig = tuple(arg_signature(a) for a in args)
        if kwargs:
            sig += tuple(f"{k}={arg_signature(v)}"
                         for k, v in sorted(kwargs.items()))
        with self._lock:
            self._sig_prev[name] = self._sig_cur.get(name)
            self._sig_cur[name] = sig

    def _signature_diff(self, name: str) -> list[str]:
        prev = self._sig_prev.get(name)
        cur = self._sig_cur.get(name)
        if cur is None:
            return ["no observed signature "
                    "(wire observe_call to attribute args)"]
        if prev is None:
            return ["first observed signature: (" + ", ".join(cur) + ")"]
        diffs = []
        for i in range(max(len(prev), len(cur))):
            p = prev[i] if i < len(prev) else "<absent>"
            c = cur[i] if i < len(cur) else "<absent>"
            if p != c:
                diffs.append(f"arg[{i}]: {p} -> {c}")
        if not diffs:
            # the JAX package's words, so both ledgers' rings read alike
            diffs = ["observed signature unchanged (retrace from an "
                     "unobserved arg, weak type, or donation)"]
        return diffs

    def poll_retraces(self) -> int:
        """Diff every watched fn's trace-cache size against the last
        poll; publish ``retrace_total{fn}`` and ring a signature diff
        per new trace batch. Returns the number of NEW retraces."""
        with self._lock:
            watched = list(self._watched.items())
        new_total = 0
        for name, fn in watched:
            size = self._cache_size(fn)
            if size is None:
                continue
            with self._lock:
                prev = self._trace_counts.get(name)
                self._trace_counts[name] = size
                if prev is None or size <= prev:
                    continue
                delta = size - prev
                self._retraces[name] = self._retraces.get(name, 0) + delta
                if self._steady_marked:
                    self._steady_retraces += delta
                self._ring.append({
                    "time": time.time(),
                    "fn": name,
                    "traces": size,
                    "new": delta,
                    "diff": self._signature_diff(name),
                })
            self._obs.counter("retrace_total", fn=name).inc(delta)
            new_total += delta
        return new_total

    def recent_retraces(self, n: int = 8) -> list[dict]:
        with self._lock:
            return list(self._ring)[-n:]

    @property
    def retrace_total(self) -> int:
        with self._lock:
            return sum(self._retraces.values())

    # -- steady-state window ------------------------------------------------

    def mark_steady(self) -> None:
        """Open the steady-state window: polls first (pending warmup
        traces are not retraces), then any further retrace or implicit
        transfer counts against the window —
        ``HealthMonitor.watch_transfers`` flips DEGRADED on either."""
        self.poll_retraces()
        with self._lock:
            self._steady_marked = True
            self._steady_retraces = 0
            self._steady_implicit = 0

    def steady_state(self) -> dict:
        with self._lock:
            return {"marked": self._steady_marked,
                    "retraces": self._steady_retraces,
                    "implicit_transfers": self._steady_implicit}

    def reset(self) -> None:
        """Zero the ledger's site totals, implicit counts, ring and
        steady-state window (watch baselines are re-polled, not
        cleared) — benches call this at the warm/streamed boundary so
        the streamed-phase totals reconcile exactly against equally
        reset store counters. Registry counters keep
        cumulating; the snapshot is the reconciliation surface."""
        self.poll_retraces()
        with self._lock:
            self._sites.clear()
            self._implicit.clear()
            self._implicit_total = 0
            self._retraces = {name: 0 for name in self._watched}
            self._ring.clear()
            self._steady_retraces = 0
            self._steady_implicit = 0

    # -- snapshot (the /transferz body) -------------------------------------

    def snapshot(self) -> dict:
        """One JSON-safe dict of the whole plane: per-site totals and
        effective GB/s, implicit-transfer attribution, retrace counts
        + the diff ring, the steady-state window. Polls retraces
        first, so the body is current."""
        self.poll_retraces()
        with self._lock:
            sites = {}
            for name, s in sorted(self._sites.items()):
                sites[name] = {
                    "h2d_bytes": s.h2d_bytes,
                    "d2h_bytes": s.d2h_bytes,
                    "h2d_count": s.h2d_count,
                    "d2h_count": s.d2h_count,
                    "wait_s": s.wait_s,
                    "effective_gbs": s.effective_gbs(),
                }
            return {
                "time": time.time(),
                "guard_mode": self.guard_mode,
                "sites": sites,
                "implicit_transfers_total": self._implicit_total,
                "implicit_by_site": dict(sorted(self._implicit.items())),
                "retraces": {
                    "total": sum(self._retraces.values()),
                    "by_fn": dict(sorted(self._retraces.items())),
                    "ring": list(self._ring),
                },
                "steady": {"marked": self._steady_marked,
                           "retraces": self._steady_retraces,
                           "implicit_transfers": self._steady_implicit},
            }


class TransferSteadyCheck:
    """The ``HealthMonitor`` check over a ``TransferLedger``'s
    steady-state window: OK through warmup (``mark_steady()`` not yet
    called), DEGRADED the moment any post-warmup rebuild/reload or
    implicit transfer lands."""

    def __init__(self, ledger: TransferLedger):
        self._ledger = ledger

    def __call__(self):
        from large_scale_recommendation_tpu_torch.obs.health import (
            degraded,
            ok,
        )

        self._ledger.poll_retraces()
        st = self._ledger.steady_state()
        if not st["marked"]:
            return ok(note="warmup (mark_steady() not called)", **st)
        if st["retraces"] or st["implicit_transfers"]:
            return degraded(recent=self._ledger.recent_retraces(3), **st)
        return ok(**st)


# --------------------------------------------------------------------------
# Module plane: default None, like every optional plane
# --------------------------------------------------------------------------

_TRANSFERS: TransferLedger | None = None


def get_transfers() -> TransferLedger | None:
    """The currently installed transfer ledger, or ``None``."""
    return _TRANSFERS


def set_transfers(ledger: TransferLedger | None) -> None:
    """Install ``ledger`` as the process's TRANSFER plane (``None`` to
    clear) — latest wins, the same single-instance convention as the
    recorder/introspector."""
    global _TRANSFERS
    _TRANSFERS = ledger


def guard_scope(site: str):
    """Hot-path helper: the installed ledger's ``guard(site)``, or the
    shared null context when the plane is absent — one call, zero
    allocations either way when unarmed."""
    t = get_transfers()
    if t is None:
        return _NULL_CONTEXT
    return t.guard(site)


def allow_scope(site: str):
    """Hot-path helper: the installed ledger's ``allow(site)``, or the
    shared null context when the plane is absent."""
    t = get_transfers()
    if t is None:
        return _NULL_CONTEXT
    return t.allow(site)


def transferz() -> dict:
    """The ``/transferz`` body: the installed ledger's snapshot, or the
    standard absent-plane note."""
    t = get_transfers()
    if t is None:
        return {"note": "transfer ledger not enabled "
                        "(obs.enable_transfers)", "sites": {}}
    return t.snapshot()
