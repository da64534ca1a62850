"""Nested-span tracer exporting Chrome trace-event JSON (counterpart of
``large_scale_recommendation_tpu.obs.trace``).

CUDA work is asynchronous: a host clock around a kernel launch measures the
enqueue, not the work. The tracer makes device time visible:

- ``span(name, ...)`` is a context manager; the yielded ``Span`` takes
  ``span.out = result`` and the tracer waits for the work that produced it
  before stopping the clock (``_block``: an event recorded on the current
  stream of each CUDA tensor's device, then synchronized on; CPU tensors
  and host values pass through).
- ``span(name, key=...)``: the first span seen with a key is categorized
  ``"compile"``, every later one ``"execute"`` (the first/steady split).
  The port has no XLA compile; what the first call pays instead is the
  kernel library's build or load, and ``install_build_hook()`` publishes
  each one as ``kernel_build_s{library=}`` with a ``kernel_build``
  instant event.

Spans nest per thread, carry namespaced ids (``process_namespace()``) and
``TraceContext`` causal links, and export as Chrome *complete* events
(``"ph": "X"``, microsecond ``ts``/``dur``) that Perfetto loads;
``validate_chrome_trace`` is the schema contract. ``NullTracer`` is the
disabled twin.

**Liveness.** A span is *live* when the tracer is enabled or when a
``torch.profiler`` capture is recording (one flag read,
``torch.autograd.profiler._is_profiler_enabled``). With neither,
``NullTracer.span`` returns the shared no-op ``NULL_SPAN``: no clock, no
table, no CUDA event. ``span(name, ...)`` at module level opens a span on
the module-level tracer, for code that holds none of its own. A live span:

- opens a host profiler range of its own name
  (``torch._C._profiler._RecordFunctionFast``), so its phase shares
  Kineto's clock with the kernels and a device trace can name the host
  work around an idle gap. Not ``torch.profiler.record_function``: that
  makes a *user annotation*, which Kineto mirrors onto the device
  timeline as if it were device work; a fast record function is a plain
  host op (``is_user_annotation() is False``);
- adds to a per-name table, ``span_totals()``: the count, the wall, the
  self time (the wall less that of the live spans opened inside it on the
  same thread) and the sums of the numeric args, which serve as counters
  (``span.note(**args)`` adds args known only inside the span);
- with ``device=True``, records a CUDA event pair on the current stream;
  the table resolves the pairs into ``device_ms`` when it is read, so
  nothing waits on the hot path.

``reset_span_totals()`` clears the table. An enabled tracer keeps its
Chrome buffer and key walls as well.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from typing import Any

import torch
from torch.autograd import profiler as _autograd_profiler

# a host profiler range that is no user annotation (absent before torch
# 2.2: live spans then only feed the table)
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)

# cap on buffered events: a runaway instrumented loop must not grow the
# host heap without bound; overflow is counted, not silently dropped
DEFAULT_MAX_EVENTS = 200_000
# cap on the per-compile-key wall-aggregate table: compile keys embed
# SHAPES, so a long-lived process with churning geometries (growing
# catalogs, online table growth) mints fresh keys forever — same
# bounded-memory discipline as the flight recorder's series table and
# the introspector's record table
DEFAULT_MAX_KEY_WALLS = 4096

# caps of the span table: distinct names, and CUDA event pairs waiting to
# be resolved (past it, finished pairs are folded in without a wait, and
# a pair that still finds no room is counted in ``device_dropped``)
DEFAULT_MAX_SPAN_NAMES = 4096
DEFAULT_MAX_PENDING_PAIRS = 1 << 16

# span sequence numbers are PROCESS-unique (module-level, not
# per-tracer): an enable()/disable()/enable() cycle must not restart the
# sequence, or a journal/bundle spanning both cycles would join events
# against the wrong spans. None means "no span"; next() is atomic under
# the GIL. The full span id is the sequence NAMESPACED by (host, pid) —
# ``process_namespace()`` — so artifacts merged across a pod
# (the JAX package's ``obs.disttrace.assemble_pod_trace``) can never collide.
_SPAN_IDS = itertools.count(1)

_NS_PID: int | None = None
_NS: str = ""


def process_namespace() -> str:
    """``"<host>-<pid>"`` — the namespace every exported span id and
    event-journal record id carries, so artifacts from different
    processes (or hosts) stay joinable after a pod merge with zero
    collisions. Re-derived when the pid changes (a fork after import
    must not inherit the parent's namespace)."""
    global _NS_PID, _NS
    pid = os.getpid()
    if pid != _NS_PID:
        _NS = f"{socket.gethostname()}-{pid}"
        _NS_PID = pid
    return _NS


def span_seq(span_id: str) -> int:
    """The process-monotonic sequence part of a namespaced span id —
    ordering WITHIN one process (cross-process ids are not ordered)."""
    return int(str(span_id).rsplit(":", 1)[1])


class TraceContext:
    """Explicit causal context carried across thread and process
    boundaries — the Dapper-style propagation token the data path
    threads through WAL batches and retrain threads:

    - ``trace_id`` names the TRACE the work belongs to. For stream data
      it is derived deterministically from the record's durable identity
      (the JAX package's ``obs.disttrace.record_trace_id``): every
      process computes the same id from (partition, offset) with no side
      channel — the WAL offsets ARE the causal tokens that cross the
      process boundary.
    - ``parent_span_id`` is the (namespaced) span to parent the next
      TOP-LEVEL span under when the context is re-entered on another
      thread (``Tracer.activate``) — how a background retrain's span
      resolves to the batch span that triggered it.

    Capture with ``Tracer.capture_context()``, re-enter with
    ``Tracer.activate(ctx)``. While active, every span the thread opens
    exports the context's ``trace_id`` in its args."""

    __slots__ = ("trace_id", "parent_span_id")

    def __init__(self, trace_id: str | None = None,
                 parent_span_id: str | None = None):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id

    def __repr__(self) -> str:  # artifacts/debugging
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"parent_span_id={self.parent_span_id!r})")


class _CtxScope:
    """Context manager returned by ``Tracer.activate``: pushes one
    ``TraceContext`` onto the calling thread's context stack."""

    __slots__ = ("_tracer", "_ctx")

    def __init__(self, tracer: "Tracer", ctx: TraceContext):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self) -> TraceContext:
        self._tracer._ctxs().append(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = self._tracer._ctxs()
        if stack and stack[-1] is self._ctx:
            stack.pop()


class _NullScope:
    """Shared no-op scope for ``activate(None)`` and the null tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        pass


NULL_SCOPE = _NullScope()


def _tensors(x: Any):
    """The tensors in ``x`` (a tensor, or tuples, lists and dicts of
    them, nested); anything else yields nothing."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _block(x: Any) -> None:
    """Wait until the device work producing ``x`` is done: one event
    recorded on the current stream of each CUDA device among ``x``'s
    tensors, then synchronized on. Not ``torch.cuda.synchronize()``, which
    would also wait for other threads' streams (a retrain thread, ingest
    consumers) and charge their work to this span. CPU tensors and host
    values pass through."""
    if x is None:
        return
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _SpanTable:
    """Per-name totals of the live spans (``span_totals()``)."""

    def __init__(self):
        self.max_names = DEFAULT_MAX_SPAN_NAMES
        self.max_pending = DEFAULT_MAX_PENDING_PAIRS
        self._lock = threading.Lock()
        self._rows: dict[str, dict] = {}
        self._pending: list = []  # (row, start event, end event)
        self.names_dropped = 0
        self.device_dropped = 0

    def add(self, name: str, wall_s: float, self_s: float, args: dict,
            pair) -> None:
        with self._lock:
            row = self._rows.get(name)
            if row is None:
                if len(self._rows) >= self.max_names:
                    self.names_dropped += 1
                    return
                row = self._rows[name] = {"count": 0, "wall_ms": 0.0,
                                          "self_ms": 0.0, "args": {}}
            row["count"] += 1
            row["wall_ms"] += 1e3 * wall_s
            row["self_ms"] += 1e3 * self_s
            sums = row["args"]
            for k, v in args.items():
                if isinstance(v, (int, float)):
                    sums[k] = sums.get(k, 0) + v
            if pair is None:
                return
            row.setdefault("device_ms", 0.0)
            if len(self._pending) >= self.max_pending:
                self._fold_finished()
            if len(self._pending) >= self.max_pending:
                self.device_dropped += 1
                return
            self._pending.append((row, *pair))

    def _fold_finished(self) -> None:
        """Resolve the leading pairs whose end has been reached, without a
        wait (caller holds the lock)."""
        done = 0
        for row, a, b in self._pending:
            if not b.query():
                break
            row["device_ms"] += a.elapsed_time(b)
            done += 1
        del self._pending[:done]

    def totals(self) -> dict:
        with self._lock:
            pending, self._pending = self._pending, []
        resolved = []
        for row, a, b in pending:
            b.synchronize()
            resolved.append((row, a.elapsed_time(b)))
        with self._lock:
            for row, ms in resolved:
                row["device_ms"] += ms
            return {name: dict(row, args=dict(row["args"]))
                    for name, row in self._rows.items()}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._pending.clear()
            self.names_dropped = 0
            self.device_dropped = 0


_TABLE = _SpanTable()
# the live spans open on each thread, innermost last: a span's self time
# is its wall less its children's
_OPEN = threading.local()


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def span_totals() -> dict:
    """The live spans' totals by name since the last
    ``reset_span_totals()``: ``{name: {"count", "wall_ms", "self_ms",
    "args": {arg: sum}, "device_ms" (spans opened with device=True)}}``.
    Waits for the recorded CUDA event pairs to resolve them: call it off
    the hot path."""
    return _TABLE.totals()


def reset_span_totals() -> None:
    """Clear the table of ``span_totals()``."""
    _TABLE.reset()


class _LiveSpan:
    """A span something listens to (the module docstring's liveness
    rule): a host profiler range, a row of the span table and, with
    ``device``, a CUDA event pair. ``out`` is taken and ignored: only an
    enabled tracer's ``Span`` waits for it."""

    __slots__ = ("name", "args", "device", "out", "t0", "_rf", "_ev0",
                 "_child_s")

    def __init__(self, name: str, args: dict, device: bool = False):
        self.name = name
        self.args = args
        self.device = device
        self.out = None
        self.t0 = 0.0
        self._rf = None
        self._ev0 = None
        self._child_s = 0.0

    def note(self, **args) -> None:
        """Add args (counters) known only inside the span."""
        self.args.update(args)

    def _open(self) -> None:
        if _RecordFunctionFast is not None:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        if self.device:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        _open_spans().append(self)
        self.t0 = time.perf_counter()

    def _close(self, t1: float) -> None:
        wall = t1 - self.t0
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1]._child_s += wall
        pair = None
        if self._ev0 is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pair = (self._ev0, end)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _TABLE.add(self.name, wall, wall - self._child_s, self.args, pair)

    def __enter__(self) -> "_LiveSpan":
        self._open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._close(time.perf_counter())


class Span(_LiveSpan):
    """One open span of an enabled tracer (always live). Set ``out`` to
    the computation's result (a tensor,
    or tuples, lists and dicts of them) to have the tracer wait for it
    before the clock stops; add
    display attributes via ``args``. ``id`` is a NAMESPACED
    ``"<host>-<pid>:<seq>"`` string — globally unique, so pod-merged
    artifacts can never collide — and lands in the exported event's
    args: the correlation token ``obs.events.EventJournal`` stamps onto
    events emitted while this span is open. ``key`` is the compile key
    (or None): while the span is open, ``obs.introspect`` attributes the
    kernel records the launchers note to it, which is how kernels join the
    span family. The exported args additionally carry
    ``parent_span_id`` (the enclosing span on this thread, or the
    active ``TraceContext``'s parent for a top-level span — the
    cross-thread causal link) and ``trace_id`` (the active context's)."""

    __slots__ = ("cat", "id", "key", "parent_id", "trace_id", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict,
                 span_id: str, key: Any = None, device: bool = False):
        super().__init__(name, args, device)
        self._tracer = tracer
        self.cat = cat
        self.id = span_id
        self.key = key
        self.parent_id = None
        self.trace_id = None

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        ctx = self._tracer.current_context()
        if ctx is not None:
            self.trace_id = ctx.trace_id
        if stack:
            self.parent_id = stack[-1].id
        elif ctx is not None:
            # top-level span on this thread under an activated context:
            # parent to the span that captured the context (the retrain
            # lane's link back to its triggering batch)
            self.parent_id = ctx.parent_span_id
        stack.append(self)
        self._open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.out is not None:
            _block(self.out)
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._close(t1)
        self._tracer._record(self, t1)


class _NullSpan:
    """Shared stateless no-op span/context manager — the whole disabled
    tracing path is a flag read, two attribute lookups and two no-op
    calls."""

    __slots__ = ()
    name = ""
    cat = ""
    args: dict = {}
    id = None
    key = None
    parent_id = None
    trace_id = None

    # writes to .out on the shared singleton are dropped (it has no
    # per-instance storage), which is exactly the point
    @property
    def out(self):
        return None

    @out.setter
    def out(self, value):
        pass

    def note(self, **args) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans into a Chrome-trace event buffer.

    Thread-safe: the event buffer append is locked; the span stack and
    the perf-counter origin are thread-local / immutable."""

    enabled = True

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._compile_keys: set = set()
        # per-compile-key wall aggregates (compile/execute split), the
        # measured half of the roofline join in ``obs.introspect``:
        # key → {compile_count, compile_total_s, execute_count,
        # execute_total_s, execute_min_s, execute_max_s, iterations}.
        # Hard-capped: fresh keys past the cap are counted, not stored
        self.max_key_walls = DEFAULT_MAX_KEY_WALLS
        self.key_walls_dropped = 0
        self._key_walls: dict = {}
        # perf_counter → epoch-anchored microseconds, so traces from
        # separate processes can be laid side by side
        self._origin = time.time() - time.perf_counter()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _ctxs(self) -> list:
        stack = getattr(self._local, "ctxs", None)
        if stack is None:
            stack = self._local.ctxs = []
        return stack

    # -- cross-thread / cross-process context -------------------------------

    def current_context(self) -> TraceContext | None:
        """The innermost ``TraceContext`` activated on the calling
        thread (``activate``), or None."""
        stack = self._ctxs()
        return stack[-1] if stack else None

    def capture_context(self) -> TraceContext:
        """Snapshot the calling thread's causal position: the active
        context's ``trace_id`` (if any) plus the innermost OPEN span's
        id as ``parent_span_id``. Hand the result to another thread and
        ``activate`` it there — its top-level spans then parent back to
        this thread's span in the exported trace (the retrain-lane
        link)."""
        ctx = self.current_context()
        return TraceContext(
            trace_id=None if ctx is None else ctx.trace_id,
            parent_span_id=self.current_span_id())

    def activate(self, ctx: TraceContext | None):
        """Context manager entering ``ctx`` on the calling thread:
        spans opened inside export the context's ``trace_id``, and
        top-level spans parent to its ``parent_span_id``.
        ``activate(None)`` is a shared no-op — callers pass a batch's
        (possibly absent) context straight through."""
        if ctx is None:
            return NULL_SCOPE
        return _CtxScope(self, ctx)

    # -- span API -----------------------------------------------------------

    def span(self, name: str, key: Any = None, device: bool = False,
             **args) -> Span:
        """Open a span (use as a context manager).

        ``key`` opts into compile/execute categorization: the first span
        with a given key is labeled ``compile`` (it pays the first-call
        costs: library build or load, allocator growth), later ones
        ``execute``. Keys must be hashable; a good key is
        (fn_name, shape-tuple). ``device=True`` (work queued on the card)
        adds a CUDA event pair: ``device_ms`` in ``span_totals()``."""
        cat = "span"
        if key is not None:
            with self._lock:
                if key in self._compile_keys:
                    cat = "execute"
                else:
                    self._compile_keys.add(key)
                    cat = "compile"
        return Span(self, name, cat, args,
                    f"{process_namespace()}:{next(_SPAN_IDS)}", key, device)

    def depth(self) -> int:
        """Current nesting depth on the calling thread."""
        return len(self._stack())

    def current_span_id(self) -> str | None:
        """The (namespaced) id of the innermost OPEN span on the
        calling thread, or ``None`` outside any span — the correlation
        token the event journal stamps onto events (``span_id`` also
        lands in every exported trace event's args, so event↔span joins
        work from the artifacts alone, including pod-merged ones)."""
        stack = self._stack()
        return stack[-1].id if stack else None

    def current_compile_key(self) -> Any:
        """The compile key of the innermost OPEN keyed span on the
        calling thread, or ``None`` — how ``obs.introspect`` attributes
        the kernel records noted mid-span to the span family that
        carried them."""
        for span in reversed(self._stack()):
            if span.key is not None:
                return span.key
        return None

    def key_walls(self) -> dict:
        """Snapshot of the per-compile-key wall aggregates: for every
        keyed span family, the compile-labeled count/total wall and the
        execute-labeled count/total/min/max walls plus the summed
        ``iterations`` span arg (1 per span when absent) — the measured
        side ``obs.introspect.roofline_rows`` joins against the kernel
        records."""
        with self._lock:
            return {k: dict(v) for k, v in self._key_walls.items()}

    def _aggregate_key_wall(self, span: Span, wall_s: float) -> None:
        # caller holds self._lock
        agg = self._key_walls.get(span.key)
        if agg is None:
            if len(self._key_walls) >= self.max_key_walls:
                self.key_walls_dropped += 1
                return
            agg = self._key_walls[span.key] = {
                "compile_count": 0, "compile_total_s": 0.0,
                "execute_count": 0, "execute_total_s": 0.0,
                "execute_min_s": float("inf"), "execute_max_s": 0.0,
                "iterations": 0,
            }
        if span.cat == "compile":
            agg["compile_count"] += 1
            agg["compile_total_s"] += wall_s
        else:
            agg["execute_count"] += 1
            agg["execute_total_s"] += wall_s
            agg["execute_min_s"] = min(agg["execute_min_s"], wall_s)
            agg["execute_max_s"] = max(agg["execute_max_s"], wall_s)
            try:
                agg["iterations"] += int(span.args.get("iterations", 1))
            except (TypeError, ValueError):
                agg["iterations"] += 1

    def _record(self, span: Span, t1: float) -> None:
        with self._lock:
            if span.key is not None:
                self._aggregate_key_wall(span, t1 - span.t0)
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            args = dict(span.args, span_id=span.id)
            if span.parent_id is not None:
                args["parent_span_id"] = span.parent_id
            if span.trace_id is not None:
                args["trace_id"] = span.trace_id
            self._events.append({
                "name": span.name,
                "cat": span.cat,
                "ph": "X",
                "ts": (span.t0 + self._origin) * 1e6,
                "dur": (t1 - span.t0) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args,
            })

    def complete(self, name: str, t0: float, t1: float,
                 cat: str = "complete", tid: int | None = None,
                 **args) -> str | None:
        """Append one ALREADY-MEASURED complete event: ``t0``/``t1``
        are historical ``perf_counter`` readings the caller paid
        elsewhere (the request plane's exemplar span trees — the walls
        were measured on the serving path; re-opening live spans would
        re-read clocks and lie about when). Same buffer bound and
        epoch-anchoring as live spans; ``tid`` overrides the thread id
        so reconstructed trees can render on their own track. Returns
        the minted ``span_id`` (``None`` when the buffer dropped it) —
        the correlation token for event↔span joins."""
        span_id = f"{process_namespace()}:{next(_SPAN_IDS)}"
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return None
            self._events.append({
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": (t0 + self._origin) * 1e6,
                "dur": max(0.0, t1 - t0) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident() if tid is None else int(tid),
                "args": dict(args, span_id=span_id),
            })
        return span_id

    def complete_tree(self, name: str, t0: float, t1: float,
                      children, cat: str = "complete",
                      child_cat: str = "complete",
                      tid: int | None = None, **args) -> str | None:
        """Append one reconstructed span tree: a parent complete-event
        over ``[t0, t1]`` plus ``children`` (``[(name, dur_s), ...]``,
        zero/negative durations skipped) laid back-to-back from ``t0``.
        Child boundaries are computed in the event's own MICROSECOND
        space — each child's ``ts`` is the previous child's ``ts + dur``
        with the very same floats a validator re-adds, and the last end
        is clamped to the parent's — because converting each boundary
        from seconds independently does not survive the epoch anchor:
        at ~1e15 µs one ulp is ~0.25 µs, enough to un-nest abutting
        siblings under ``validate_chrome_trace``. Returns the parent
        ``span_id`` (``None`` when the buffer dropped it)."""
        span_id = f"{process_namespace()}:{next(_SPAN_IDS)}"
        rtid = threading.get_ident() if tid is None else int(tid)
        pts = (t0 + self._origin) * 1e6
        pdur = max(0.0, t1 - t0) * 1e6
        pend = pts + pdur
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return None
            self._events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": pts, "dur": pdur, "pid": os.getpid(), "tid": rtid,
                "args": dict(args, span_id=span_id),
            })
            cursor = pts
            for cname, dur_s in children:
                if dur_s <= 0.0:
                    continue
                dur = min(dur_s * 1e6, pend - cursor)
                if dur <= 0.0:
                    continue
                if len(self._events) >= self.max_events:
                    self.dropped += 1
                    continue
                self._events.append({
                    "name": cname, "cat": child_cat, "ph": "X",
                    "ts": cursor, "dur": dur, "pid": os.getpid(),
                    "tid": rtid,
                    "args": {
                        "span_id":
                            f"{process_namespace()}:{next(_SPAN_IDS)}",
                        "parent_span_id": span_id,
                    },
                })
                cursor = cursor + dur
        return span_id

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration instant event (``"ph": "i"``) — swap
        markers, checkpoint boundaries. Stamped with the ENCLOSING open
        span's id (or None), same correlation contract as complete
        events."""
        span_id = self.current_span_id()
        ctx = self.current_context()
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            full_args = dict(args, span_id=span_id)
            if ctx is not None and ctx.trace_id is not None:
                full_args.setdefault("trace_id", ctx.trace_id)
            self._events.append({
                "name": name,
                "cat": "instant",
                "ph": "i",
                "s": "t",
                "ts": (time.perf_counter() + self._origin) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": full_args,
            })

    # -- kernel-library build hook -------------------------------------------

    def install_build_hook(self, registry=None) -> bool:
        """Publish each kernel library build or load
        (``ops._build.load_library``) into ``registry`` (default: the
        module-level one) as a ``kernel_build_s{library=}`` histogram and
        into the trace as a ``kernel_build`` instant event. The port's
        counterpart of the JAX tracer's XLA compile hook: a library's
        first use is what a first call pays here. The loads made before
        the hook was armed are published into the histogram at once (a
        process usually builds its libraries first). Replaces any hook
        installed before; returns True."""
        from large_scale_recommendation_tpu_torch.ops import _build

        if registry is None:
            from large_scale_recommendation_tpu_torch.obs.registry import (
                get_registry,
            )

            registry = get_registry()

        def _listener(library: str, seconds: float, built: bool) -> None:
            registry.histogram("kernel_build_s",
                               library=library).observe(seconds)
            self.instant("kernel_build", library=library,
                         duration_s=seconds, built=built)

        with _build._LOCKS_GUARD:
            past = {n: list(v) for n, v in _build.loads.items()}
            _build.set_build_hook(_listener)
        for library, entries in past.items():
            for seconds, _ in entries:
                registry.histogram("kernel_build_s",
                                   library=library).observe(seconds)
        return True

    # -- export -------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON document (``traceEvents`` array,
        complete events with µs timestamps) — Perfetto-loadable."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def to_chrome_trace(self, path: str) -> dict:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


class NullTracer(Tracer):
    """Disabled tracer: every span is the shared no-op singleton, unless a
    ``torch.profiler`` capture is recording (then a live span without the
    Chrome buffer)."""

    enabled = False

    def __init__(self):  # no buffer, no lock
        self.max_events = 0
        self.dropped = 0
        self.max_key_walls = 0
        self.key_walls_dropped = 0

    def span(self, name: str, key: Any = None, device: bool = False,
             **args):
        if not _autograd_profiler._is_profiler_enabled:
            return NULL_SPAN
        return _LiveSpan(name, args, device)

    def complete(self, name: str, t0: float, t1: float,
                 cat: str = "complete", tid: int | None = None,
                 **args) -> str | None:
        return None

    def complete_tree(self, name: str, t0: float, t1: float,
                      children, cat: str = "complete",
                      child_cat: str = "complete",
                      tid: int | None = None, **args) -> str | None:
        return None

    def instant(self, name: str, **args) -> None:
        pass

    def depth(self) -> int:
        return 0

    def current_span_id(self) -> str | None:
        return None

    def current_context(self) -> TraceContext | None:
        return None

    def capture_context(self) -> TraceContext | None:
        # None, not an empty context: callers gate their activate()/
        # thread handoff on one `is not None` test — no allocation on
        # the disabled path
        return None

    def activate(self, ctx):
        return NULL_SCOPE

    def current_compile_key(self) -> Any:
        return None

    def key_walls(self) -> dict:
        return {}

    def install_build_hook(self, registry=None) -> bool:
        return False

    def events(self) -> list[dict]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
_TRACER: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    """The module-level default tracer (null unless ``obs.enable()``
    installed a live one)."""
    return _TRACER


def set_tracer(tracer: Tracer) -> None:
    global _TRACER
    _TRACER = tracer


def span(name: str, device: bool = False, **args):
    """A span on the module-level tracer (``get_tracer().span``), for code
    that holds no tracer of its own."""
    tracer = _TRACER
    if not (tracer.enabled or _autograd_profiler._is_profiler_enabled):
        return NULL_SPAN
    return tracer.span(name, device=device, **args)


def validate_chrome_trace(doc: dict) -> list[dict]:
    """Schema contract for exported traces (the golden test pins this):

    - top level: ``{"traceEvents": [...]}``
    - every complete event: string ``name``/``cat``, ``ph == "X"``,
      numeric ``ts``, non-negative ``dur``, int ``pid``/``tid``,
      dict ``args``
    - metadata events (``ph == "M"``, e.g. the ``process_name`` rows a
      pod merge injects) need only a string ``name`` and an int ``pid``
    - events on one thread NEST: two complete events on the same
      (pid, tid) either don't overlap in time or one contains the
      other — partial overlap means the span stack was corrupted. The
      group key is (pid, tid), not tid alone: a pod-merged trace
      legitimately holds different processes' threads with colliding
      OS thread ids.

    Returns the complete events; raises ``ValueError`` on violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must have a traceEvents array")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    complete = []
    for e in events:
        if not isinstance(e, dict) or not isinstance(e.get("name"), str):
            raise ValueError(f"bad event (name): {e!r}")
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            raise ValueError(f"unexpected phase {ph!r} in {e.get('name')!r}")
        if not isinstance(e.get("pid"), int):
            raise ValueError(f"bad pid in {e['name']!r}")
        if ph == "M":  # metadata: no timing fields
            continue
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"bad ts in {e['name']!r}")
        if not isinstance(e.get("tid"), int):
            raise ValueError(f"bad tid in {e['name']!r}")
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"bad dur in {e['name']!r}")
            if not isinstance(e.get("args"), dict):
                raise ValueError(f"bad args in {e['name']!r}")
            complete.append(e)
    by_tid: dict[tuple[int, int], list[dict]] = {}
    for e in complete:
        by_tid.setdefault((e["pid"], e["tid"]), []).append(e)
    for tid, evs in by_tid.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        open_stack: list[tuple[float, str]] = []
        for e in evs:
            end = e["ts"] + e["dur"]
            while open_stack and open_stack[-1][0] <= e["ts"]:
                open_stack.pop()
            # float µs round-trips through JSON can wiggle by sub-µs;
            # tolerate that at the containment check
            if open_stack and end > open_stack[-1][0] + 0.5:
                raise ValueError(
                    f"events overlap without nesting on tid {tid}: "
                    f"{e['name']!r} ends after enclosing "
                    f"{open_stack[-1][1]!r}")
            open_stack.append((end, e["name"]))
    return complete
