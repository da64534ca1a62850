"""Structured event journal: severity-tagged, span-correlated, ring-bounded
(counterpart of ``large_scale_recommendation_tpu.obs.events``).

Metrics answer "how much"; the flight recorder's series answer "how did
it trend"; this module answers "WHAT HAPPENED" — the discrete state
changes an incident reconstruction hangs its timeline on: catalog swaps,
checkpoint commits, retrain start/install/abort, watchdog findings,
dead-letter quarantines, WAL segment rolls, health transitions. Each
event carries:

- ``time`` (epoch seconds), a process-monotonic ``seq``, and a
  globally-unique ``id`` — the seq NAMESPACED by ``(host, pid)``
  (``obs.trace.process_namespace``), so event tails merged across a pod
  stay joinable with zero id collisions
- ``kind`` — dotted taxonomy name (``serving.catalog_swap``,
  ``stream.checkpoint``, ``watchdog.trip``, ... — the JAX package's
  docs/OBSERVABILITY.md holds the catalog)
- ``severity`` — one of ``debug/info/warning/error/critical``
- ``span_id`` — the innermost open tracer span on the emitting thread
  (``Tracer.current_span_id``), so an event joins against the exported
  Chrome trace (every trace event's args carry the same ``span_id``)
- ``detail`` — free-form JSON-safe payload

Storage is a fixed-capacity in-memory ring (oldest events drop, the
drop is counted, the heap never grows), optionally mirrored to a JSONL
file (``jsonl_path``) for durable tails. (The JAX package's endpoint
server and postmortem bundles read it too; in the port they come with a
later slice.)

Zero-cost when unused — the contract every emitting hot path relies on:
the module-level default is ``None`` (not a null object), components
cache ``get_events()`` at construction, and every emission site is one
``is not None`` test. No journal → no locks, no clocks, no dicts built.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque

import torch

from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import (
    get_tracer,
    process_namespace,
)

DEBUG = "debug"
INFO = "info"
WARNING = "warning"
ERROR = "error"
CRITICAL_EVENT = "critical"
EVENT_SEVERITY = {DEBUG: 0, INFO: 1, WARNING: 2, ERROR: 3,
                  CRITICAL_EVENT: 4}


def _json_safe(v):
    """Make a detail payload STRICT-JSON safe: python's json module
    happily writes NaN/Infinity tokens (and the incident path is
    exactly where they appear — a watchdog trip carries the non-finite
    loss that caused it), but RFC-8259 parsers (`jq`, JS `fetch`) then
    reject the whole /eventz body / events.jsonl. Non-finite floats
    become their repr strings; containers recurse. A 0-d tensor (a loss
    left on the card) becomes its Python number first, so a non-finite
    one is caught like a float (the JAX journal leaves a JAX scalar to
    the mirror's ``repr``); the read happens on this cold emit path
    only."""
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        v = v.item()
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


class EventJournal:
    """Ring-bounded structured event log.

    ``capacity`` bounds host memory (oldest events evict; ``dropped``
    counts them). ``jsonl_path`` additionally appends every event as one
    JSON line — the durable form a bundle or a ``tail -f`` reads.
    Thread-safe: emits land from serving, ingest, retrain, and health
    threads concurrently.
    """

    def __init__(self, capacity: int = 4096, jsonl_path: str | None = None,
                 tracer=None, registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.jsonl_path = jsonl_path
        self._tracer = tracer or get_tracer()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.total = 0  # lifetime emits (ring holds the newest `capacity`)
        obs = registry or get_registry()
        self._m_events = {s: obs.counter("obs_events_total", severity=s)
                          for s in EVENT_SEVERITY}

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.total - len(self._ring)

    def emit(self, kind: str, /, severity: str = INFO, **detail) -> dict:
        """Record one event; returns it. ``detail`` must be JSON-safe
        (the JSONL mirror and the bundle writer serialize it). ``kind``
        is positional-only (registry idiom), so ``kind=...`` in detail
        is a payload key, not a collision."""
        if severity not in EVENT_SEVERITY:
            raise ValueError(f"unknown severity {severity!r}; expected one "
                             f"of {tuple(EVENT_SEVERITY)}")
        ev = {
            "time": time.time(),
            "kind": str(kind),
            "severity": severity,
            "span_id": self._tracer.current_span_id(),
            "detail": _json_safe(detail),
        }
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            # globally-unique record id: the seq namespaced by
            # (host, pid), same discipline as Span.id — pod-merged
            # event tails join with zero collisions
            ev["id"] = f"{process_namespace()}:{self._seq}"
            self._ring.append(ev)
            self.total += 1
        self._m_events[severity].inc()
        if self.jsonl_path is not None:
            # best-effort mirror: neither a full disk nor an
            # unserializable payload may take the emitting path down
            try:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(ev, default=repr) + "\n")
            except (OSError, TypeError, ValueError):
                pass
        return ev

    # -- reads ---------------------------------------------------------------

    def events(self, kind: str | None = None,
               min_severity: str | None = None,
               limit: int | None = None) -> list[dict]:
        """Events oldest→newest, optionally filtered by kind substring
        and minimum severity; ``limit`` keeps the NEWEST matches."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if kind in e["kind"]]
        if min_severity is not None:
            floor = EVENT_SEVERITY[min_severity]
            out = [e for e in out if EVENT_SEVERITY[e["severity"]] >= floor]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def tail(self, n: int) -> list[dict]:
        return self.events(limit=n)

    def snapshot(self, limit: int | None = None) -> dict:
        """The ``/eventz`` body: newest events + accounting."""
        recent = self.events(limit=limit)
        with self._lock:
            total, buffered = self.total, len(self._ring)
        return {"recent": recent, "returned": len(recent),
                "buffered": buffered, "total": total,
                "dropped": total - buffered, "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.total = 0
            # seq is NOT reset: event ids stay process-unique

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by enable helpers
# --------------------------------------------------------------------------

_JOURNAL: EventJournal | None = None


def get_events() -> EventJournal | None:
    """The installed journal or ``None``. Emitting components cache this
    at construction and gate every emission on one ``is not None`` test
    — the same zero-cost discipline as ``model.watchdog``."""
    return _JOURNAL


def set_events(journal: EventJournal | None) -> None:
    global _JOURNAL
    _JOURNAL = journal
