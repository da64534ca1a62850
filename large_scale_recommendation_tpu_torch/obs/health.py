"""SLO tracking for serving (counterpart of the ``SLOTracker`` part of
``large_scale_recommendation_tpu.obs.health``).

Only what the serving engine and its admission ladder read is ported: the
sliding violation window and the tracker's attainment / burn / budget
arithmetic, which is the JAX package's exactly. The registry gauges and
counters the JAX tracker publishes are not (obs is ported last).
"""

from __future__ import annotations

import threading
from collections import deque


class _WindowReservoir:
    """One sliding violation window: a bounded deque of booleans plus a
    running violation count. Not thread-safe on its own: the owner
    serializes ``push`` under its lock."""

    __slots__ = ("size", "violations", "_win")

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"window must be >= 1, got {size}")
        self.size = int(size)
        self.violations = 0  # violations inside the window
        self._win: deque[bool] = deque()

    def push(self, viol: bool) -> None:
        if len(self._win) == self.size:
            self.violations -= self._win.popleft()
        self._win.append(viol)
        self.violations += viol

    @property
    def fill(self) -> int:
        return len(self._win)

    def stats(self, objective: float) -> tuple[float, float, float]:
        """(attainment, burn_rate, error_budget_remaining) over the
        current fill; the empty reservoir reads as a full budget."""
        n = len(self._win)
        if n == 0:
            return 1.0, 0.0, 1.0
        frac = self.violations / n
        burn = frac / (1.0 - objective)
        return 1.0 - frac, burn, max(0.0, 1.0 - burn)


class SLOTracker:
    """Sliding-window latency-target attainment and error-budget burn.

    ``record(latency_s)`` per served unit. Over the last ``window``
    samples:

    - ``attainment`` — fraction with latency ≤ ``target_s``;
    - ``burn_rate`` — observed violation fraction / allowed fraction
      (``1 - objective``); 1.0 = burning exactly the budget;
    - ``error_budget_remaining`` — ``max(0, 1 - burn_rate)``.

    ``windows`` adds named secondary reservoirs on the same sample stream
    (a fast/slow pair, ``{"fast": 64, "slow": 1024}``); ``burn_rates()``
    reads every window at once."""

    def __init__(self, target_s: float, objective: float = 0.99,
                 window: int = 512, name: str = "serving",
                 windows: dict[str, int] | None = None):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.window = int(window)
        self.name = name
        self._lock = threading.Lock()
        self._primary = _WindowReservoir(window)
        self._extras: dict[str, _WindowReservoir] = {
            str(w): _WindowReservoir(n) for w, n in (windows or {}).items()}
        self.count = 0  # lifetime samples
        self.violations = 0  # lifetime violations

    def record(self, latency_s: float) -> None:
        viol = not (latency_s <= self.target_s)  # NaN counts as violated
        with self._lock:
            self._primary.push(viol)
            for res in self._extras.values():
                res.push(viol)
            self.count += 1
            self.violations += viol

    @property
    def attainment(self) -> float:
        with self._lock:
            return self._primary.stats(self.objective)[0]

    @property
    def burn_rate(self) -> float:
        with self._lock:
            return self._primary.stats(self.objective)[1]

    @property
    def error_budget_remaining(self) -> float:
        with self._lock:
            return self._primary.stats(self.objective)[2]

    def burn_rates(self) -> dict[str, float]:
        """Every window's burn rate in one locked read: the primary (key
        ``"primary"``) plus each named extra."""
        with self._lock:
            rates = {"primary": self._primary.stats(self.objective)[1]}
            for w, res in self._extras.items():
                rates[w] = res.stats(self.objective)[1]
            return rates

    def snapshot(self) -> dict:
        with self._lock:
            att, burn, budget = self._primary.stats(self.objective)
            snap = {
                "name": self.name,
                "target_s": self.target_s,
                "objective": self.objective,
                "window": self.window,
                "window_fill": self._primary.fill,
                "count": self.count,
                "violations": self.violations,
                "attainment": att,
                "burn_rate": burn,
                "error_budget_remaining": budget,
            }
            if self._extras:
                snap["windows"] = {
                    w: {"size": res.size, "fill": res.fill,
                        "burn_rate": res.stats(self.objective)[1],
                        "error_budget_remaining":
                            res.stats(self.objective)[2]}
                    for w, res in self._extras.items()}
            return snap
