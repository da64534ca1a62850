"""SLO-driven admission control (counterpart of
``large_scale_recommendation_tpu.serving.admission``): a four-level
brownout ladder the engine consults on every request, driven by an
``obs.health.SLOTracker``'s burn rate, with hysteresis.

Levels, escalating:

- ``normal`` — serve exactly.
- ``widen`` — coalesce up to ``widen_factor × max_batch`` rows per flush:
  per-request latency rises, cost per row falls.
- ``degrade`` — serve stage-1-only results from the quantized fast path
  (``serving.retrieval``), flagged ``degraded``. An exact-only engine has
  no cheaper path; the level still widens batching.
- ``shed`` — reject new work with ``AdmissionRejectedError``; queued work
  still flushes.

``observe()`` (once per flush) jumps straight to the level the burn
warrants, and steps down one level at a time once the burn is below
``recover_ratio ×`` the current level's entry threshold. ``min_samples``
keeps the first flushes from tripping the ladder at warmup. Every level
change journals a ``serving.admission_transition`` event and counts
``serving_admission_transitions_total{from_level, to_level}``; the
``serving_admission_level`` gauge, ``serving_admission_shed_total`` and
``serving_admission_degraded_total`` follow the ladder (the JAX package's
instruments, bound at construction: null singletons when obs is off).
"""

from __future__ import annotations

import dataclasses
import threading

from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.registry import get_registry

NORMAL = "normal"
WIDEN = "widen"
DEGRADE = "degrade"
SHED = "shed"
LEVELS = (NORMAL, WIDEN, DEGRADE, SHED)
LEVEL_ORDER = {lvl: i for i, lvl in enumerate(LEVELS)}


class AdmissionRejectedError(RuntimeError):
    """Typed rejection: the engine is shedding load. Carries the
    controller ``level`` and the ``burn`` that drove it."""

    def __init__(self, level: str, burn: float):
        self.level = level
        self.burn = float(burn)
        super().__init__(
            f"admission rejected: level={level} burn_rate={burn:.2f}")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Ladder thresholds in burn-rate units (1.0 = burning exactly the
    error budget): escalate at 1×/2×/4×, recover at 70% of each level's
    entry threshold."""

    widen_burn: float = 1.0
    degrade_burn: float = 2.0
    shed_burn: float = 4.0
    recover_ratio: float = 0.7
    widen_factor: float = 2.0  # batching-deadline/row multiplier
    min_samples: int = 8  # window fill before any escalation
    # fraction of requests still admitted while shedding: the probe
    # traffic that refreshes the SLO window (without it a shed engine
    # would never observe recovery)
    shed_probe: float = 0.1

    def __post_init__(self):
        if not (self.widen_burn <= self.degrade_burn <= self.shed_burn):
            raise ValueError(
                f"thresholds must be ordered widen <= degrade <= shed, "
                f"got {self.widen_burn}/{self.degrade_burn}/"
                f"{self.shed_burn}")
        if not 0.0 < self.recover_ratio < 1.0:
            raise ValueError(f"recover_ratio must be in (0, 1), "
                             f"got {self.recover_ratio}")
        if self.widen_factor < 1.0:
            raise ValueError(f"widen_factor must be >= 1, "
                             f"got {self.widen_factor}")
        if not 0.0 < self.shed_probe <= 1.0:
            raise ValueError(f"shed_probe must be in (0, 1], "
                             f"got {self.shed_probe}")


class AdmissionController:
    """The ladder over one ``SLOTracker``. ``observe()`` re-evaluates the
    level from the tracker's current burn; ``check_admit()`` is the
    per-request gate. Thread-safe."""

    def __init__(self, slo, config: AdmissionConfig | None = None,
                 registry=None):
        self.slo = slo
        self.config = config or AdmissionConfig()
        self.level = NORMAL
        self.transitions = 0
        self.sheds = 0
        self.degraded = 0  # requests served degraded (count_degraded)
        self._shed_seen = 0  # requests seen while shedding (probe tick)
        self._lock = threading.Lock()
        obs = registry or get_registry()
        self._obs = obs
        self._events = get_events()
        self._m_level = obs.gauge("serving_admission_level")
        self._m_shed = obs.counter("serving_admission_shed_total")
        self._m_degraded = obs.counter("serving_admission_degraded_total")
        self._m_level.set(0)

    def _entry_threshold(self, level: str) -> float:
        cfg = self.config
        return {NORMAL: 0.0, WIDEN: cfg.widen_burn,
                DEGRADE: cfg.degrade_burn, SHED: cfg.shed_burn}[level]

    def _target_level(self, burn: float, fill: int) -> str:
        cfg = self.config
        if fill < cfg.min_samples:
            return NORMAL  # warming, not overload
        if burn >= cfg.shed_burn:
            return SHED
        if burn >= cfg.degrade_burn:
            return DEGRADE
        if burn >= cfg.widen_burn:
            return WIDEN
        return NORMAL

    def observe(self) -> str:
        """Re-evaluate the ladder from the tracker's current window:
        escalation jumps straight to the warranted level; recovery steps
        down one level at a time, once the burn is below ``recover_ratio
        ×`` the current level's entry threshold."""
        snap = self.slo.snapshot()
        burn = snap["burn_rate"]
        fill = snap["window_fill"]
        with self._lock:
            prev = self.level
            target = self._target_level(burn, fill)
            if LEVEL_ORDER[target] > LEVEL_ORDER[prev]:
                new = target
            elif LEVEL_ORDER[target] < LEVEL_ORDER[prev]:
                exit_below = (self._entry_threshold(prev)
                              * self.config.recover_ratio)
                new = (LEVELS[LEVEL_ORDER[prev] - 1]
                       if burn < exit_below else prev)
            else:
                new = prev
            changed = new != prev
            if changed:
                self.level = new
                self.transitions += 1
        if changed:
            self._m_level.set(LEVEL_ORDER[new])
            self._obs.counter("serving_admission_transitions_total",
                              from_level=prev, to_level=new).inc()
            if self._events is not None:
                severity = ("warning" if LEVEL_ORDER[new]
                            > LEVEL_ORDER[prev] else "info")
                self._events.emit(
                    "serving.admission_transition", severity=severity,
                    from_level=prev, to_level=new,
                    burn_rate=round(burn, 4),
                    attainment=round(snap["attainment"], 4),
                    window_fill=fill)
        return self.level

    def admit(self) -> bool:
        """Per-request gate: False iff the ladder is at ``shed``."""
        return self.level != SHED

    def check_admit(self) -> None:
        """Raise the typed rejection when shedding (counting it); every
        ``1/shed_probe``-th request is admitted anyway as the recovery
        probe."""
        if self.level == SHED:
            with self._lock:
                self._shed_seen += 1
                period = max(1, round(1.0 / self.config.shed_probe))
                if self._shed_seen % period == 0:
                    return  # the recovery probe
                self.sheds += 1
            self._m_shed.inc()
            raise AdmissionRejectedError(SHED, self.slo.burn_rate)

    @property
    def widen_active(self) -> bool:
        return LEVEL_ORDER[self.level] >= LEVEL_ORDER[WIDEN]

    @property
    def degrade_active(self) -> bool:
        return LEVEL_ORDER[self.level] >= LEVEL_ORDER[DEGRADE]

    @property
    def widen_factor(self) -> float:
        """The live batching multiplier: ``config.widen_factor`` at
        ``widen`` and above, 1.0 at ``normal``."""
        return self.config.widen_factor if self.widen_active else 1.0

    def count_degraded(self, n: int) -> None:
        self.degraded += n
        if n:
            self._m_degraded.inc(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"level": self.level, "transitions": self.transitions,
                    "sheds": self.sheds, "degraded": self.degraded,
                    "widen_factor": self.widen_factor,
                    "slo": self.slo.snapshot()}
