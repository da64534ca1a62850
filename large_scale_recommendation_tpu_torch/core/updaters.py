"""Learning-rate schedules and factor updaters — the SGD math contract
(counterpart of ``large_scale_recommendation_tpu.core.updaters``).

A schedule is a plain host function ``(base_lr: float, t: int) -> float``:
the drivers evaluate it once per sweep on the host and hand the kernel η as
a runtime scalar. Each schedule computes in float32 (numpy scalars), the
precision the JAX package evaluates its schedules in, so both packages feed
their kernels the same η.

The updaters are batched over tensors: ratings ``[b]``, factor rows
``[b, k]``, weights ``[b]`` (0 masks padding), omegas ``[b]``, ``t`` the
1-based sweep. Two rules live behind one interface:

    SGDUpdater             e = r − u·v;  du = η·e·v;  dv = η·e·u
    RegularizedSGDUpdater  du = −η·(λ/ω_u·u − e·v), dv symmetrically
                           (the DSGD rule, per-occurrence-weighted L2)
    MockFactorUpdater      du = dv = 0 (for plumbing tests)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

LearningRateSchedule = Callable[[float, int], float]

_f32 = np.float32


def constant_lr(base_lr: float, t: int) -> float:
    """η_t = η."""
    del t
    return float(_f32(base_lr))


def inverse_sqrt_lr(base_lr: float, t: int) -> float:
    """η_t = η/√t, the reference DSGD default decay."""
    return float(_f32(base_lr) / np.sqrt(_f32(t)))


def inv_scaling_lr(decay: float = 0.5) -> LearningRateSchedule:
    """η_t = η / t^decay."""
    return _inv_scaling_lr(float(decay))


@functools.lru_cache(maxsize=None)
def _inv_scaling_lr(decay: float) -> LearningRateSchedule:
    def schedule(base_lr: float, t: int) -> float:
        return float(_f32(base_lr) / np.power(_f32(t), _f32(decay)))

    return schedule


def bottou_lr(lambda_: float,
              optimal_init: float | None = None) -> LearningRateSchedule:
    """η_t = 1/(λ·(t₀ + t − 1)); ``optimal_init=None`` picks t₀ = 1/(λ·η₀)
    so the schedule starts at the base rate. Requires λ > 0."""
    if lambda_ <= 0:
        raise ValueError(
            f"bottou schedule requires lambda > 0, got {lambda_}"
        )
    return _bottou_lr(float(lambda_),
                      None if optimal_init is None else float(optimal_init))


@functools.lru_cache(maxsize=None)
def _bottou_lr(lambda_: float,
               optimal_init: float | None) -> LearningRateSchedule:
    def schedule(base_lr: float, t: int) -> float:
        lam = _f32(lambda_)
        if optimal_init is None:
            t0 = _f32(1.0) / (lam * _f32(base_lr))
        else:
            t0 = _f32(optimal_init)
        return float(_f32(1.0) / (lam * (t0 - _f32(1.0) + _f32(t))))

    return schedule


def xu_lr(lambda_: float, decay: float = -0.75) -> LearningRateSchedule:
    """η_t = η·(1 + λ·η·t)^decay."""
    return _xu_lr(float(lambda_), float(decay))


@functools.lru_cache(maxsize=None)
def _xu_lr(lambda_: float, decay: float) -> LearningRateSchedule:
    def schedule(base_lr: float, t: int) -> float:
        lr = _f32(base_lr)
        return float(lr * np.power(_f32(1.0) + _f32(lambda_) * lr * _f32(t),
                                   _f32(decay)))

    return schedule


def warm_boost_lr(boost_factor: float = 2.5,
                  boost_steps: int = 2) -> LearningRateSchedule:
    """η_t = boost_factor·η for the first ``boost_steps`` sweeps, then η."""
    return _warm_boost_lr(float(boost_factor), int(boost_steps))


@functools.lru_cache(maxsize=None)
def _warm_boost_lr(boost_factor: float,
                   boost_steps: int) -> LearningRateSchedule:
    def schedule(base_lr: float, t: int) -> float:
        lr = _f32(base_lr)
        return float(_f32(boost_factor) * lr if int(t) <= boost_steps
                     else lr)

    return schedule


def schedule_from_name(name: str, lambda_: float = 1.0,
                       **kwargs) -> LearningRateSchedule:
    """Config-layer registry: schedule name → callable (the factories are
    cached, so equal configs yield the same callable)."""
    if name in ("inverse_sqrt", "default"):
        return inverse_sqrt_lr
    if name == "constant":
        return constant_lr
    if name == "inv_scaling":
        return inv_scaling_lr(**kwargs)
    if name == "bottou":
        return bottou_lr(lambda_, **kwargs)
    if name == "xu":
        return xu_lr(lambda_, **kwargs)
    if name == "warm_boost":
        return warm_boost_lr(**kwargs)
    raise ValueError(
        f"unknown learning-rate schedule {name!r}; expected one of "
        "inverse_sqrt|default|constant|inv_scaling|bottou|xu|warm_boost"
    )


def _errors(ratings: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            pred: torch.Tensor | None = None) -> torch.Tensor:
    """e = r − u·v, batched. ``pred`` replaces the local dot: a rank-sharded
    mesh holds rank slices of u and v, and the full dot is the sum of the
    partial ones over the model group, taken outside the updater
    (``ops.sgd.sgd_minibatch_update``)."""
    if pred is not None:
        return ratings - pred
    return ratings - (u * v).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class SGDUpdater:
    """Plain unregularized SGD."""

    learning_rate: float = 0.01
    schedule: LearningRateSchedule = staticmethod(constant_lr)

    def delta(self, ratings, u, v, *, weights=None, omega_u=None,
              omega_v=None, t=1, pred=None):
        del omega_u, omega_v
        e = _errors(ratings, u, v, pred)
        if weights is not None:
            e = e * weights
        lr = self.schedule(self.learning_rate, int(t))
        du = lr * e[:, None] * v
        dv = lr * e[:, None] * u
        return du, dv

    def next_factors(self, ratings, u, v, *, weights=None, omega_u=None,
                     omega_v=None, t=1):
        du, dv = self.delta(ratings, u, v, weights=weights, t=t)
        return u + du, v + dv

    def delta_np(self, rating: float, u, v, t: int = 1):
        """Host-side scalar twin of ``delta`` for one rating (numpy rows
        ``u``, ``v``): the PS online path applies one rating per pull
        answer, where a tensor op per rating would cost more than the
        arithmetic."""
        lr = self.schedule(self.learning_rate, int(t))
        e = rating - float(np.dot(u, v))
        return lr * e * v, lr * e * u


@dataclasses.dataclass(frozen=True)
class RegularizedSGDUpdater:
    """SGD with per-occurrence-weighted L2 (λ/ω), the DSGD rule."""

    learning_rate: float = 0.001
    lambda_: float = 1.0
    schedule: LearningRateSchedule = staticmethod(inverse_sqrt_lr)

    def delta(self, ratings, u, v, *, weights=None, omega_u=None,
              omega_v=None, t=1, pred=None):
        e = _errors(ratings, u, v, pred)
        if weights is not None:
            e = e * weights
        return self.delta_from_errors(e, u, v, weights=weights,
                                      omega_u=omega_u, omega_v=omega_v, t=t)

    def delta_from_errors(self, e, u, v, *, weights=None, omega_u=None,
                          omega_v=None, t=1):
        """``delta`` from the weighted errors ``e = (r − u·v)·w`` already
        taken (the CUDA step pair computes them on the item side and
        reuses them on the user side)."""
        lr = self.schedule(self.learning_rate, int(t))
        if omega_u is not None:
            reg_u = (self.lambda_ / omega_u.clamp_min(1.0))[:, None] * u
        else:
            reg_u = self.lambda_ * u
        if omega_v is not None:
            reg_v = (self.lambda_ / omega_v.clamp_min(1.0))[:, None] * v
        else:
            reg_v = self.lambda_ * v
        if weights is not None:
            # padding rows must contribute exactly zero delta
            reg_u = reg_u * weights[:, None]
            reg_v = reg_v * weights[:, None]
        du = -lr * (reg_u - e[:, None] * v)
        dv = -lr * (reg_v - e[:, None] * u)
        return du, dv

    def next_factors(self, ratings, u, v, *, weights=None, omega_u=None,
                     omega_v=None, t=1):
        du, dv = self.delta(ratings, u, v, weights=weights, omega_u=omega_u,
                            omega_v=omega_v, t=t)
        return u + du, v + dv


@dataclasses.dataclass(frozen=True)
class MockFactorUpdater:
    """No-op updater for plumbing tests: zero deltas, factors unchanged."""

    def delta(self, ratings, u, v, *, weights=None, omega_u=None,
              omega_v=None, t=1, pred=None):
        del ratings, weights, omega_u, omega_v, t, pred
        return torch.zeros_like(u), torch.zeros_like(v)

    def next_factors(self, ratings, u, v, *, weights=None, omega_u=None,
                     omega_v=None, t=1):
        del ratings, weights, omega_u, omega_v, t
        return u, v
