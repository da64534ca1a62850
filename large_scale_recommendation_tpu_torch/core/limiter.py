"""Throughput limiter for paced streaming replay (counterpart of
``large_scale_recommendation_tpu.core.limiter``; framework-free, the same
code): let ``let_through`` elements pass per ``per_millisec`` window,
sleeping out the remainder of the window once the quota is hit.
"""

from __future__ import annotations

import time
from typing import TypeVar

A = TypeVar("A")


class ThroughputLimiter:
    """A token-window limiter: ``let_through`` elements per
    ``per_millisec`` window."""

    def __init__(self, let_through: int, per_millisec: float):
        self.let_through = let_through
        self.per_millisec = per_millisec
        self._batch_start: float | None = None
        self._cnt = 0

    def emit_or_wait(self, element: A) -> A:
        if self._batch_start is None:
            self._batch_start = time.monotonic()
        self._cnt += 1
        if self._cnt > self.let_through:
            now = time.monotonic()
            wait = self._batch_start + self.per_millisec / 1000.0 - now
            if wait > 0:
                time.sleep(wait)
            self._batch_start = now
            self._cnt = 0
        return element

    def emit_batch_or_wait(self, batch_size: int) -> None:
        """Batched form: account for ``batch_size`` elements at once (the
        micro-batch drivers emit whole arrays, not single triples).

        A batch spanning multiple quota windows pays one window wait per
        ``let_through`` elements, so the long-run rate matches the
        per-element form regardless of batch size."""
        if self._batch_start is None:
            self._batch_start = time.monotonic()
        self._cnt += batch_size
        window = self.per_millisec / 1000.0
        while self._cnt > self.let_through:
            target = self._batch_start + window
            wait = target - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            # advance to the next window boundary (or now, if we're behind)
            self._batch_start = max(target, time.monotonic() - window)
            self._cnt -= self.let_through
