"""The port's schedules and updaters against the JAX package's: rtol 1e-6,
with atol 1e-8 for entries near zero (both evaluate in float32, but the
dot-reduction order differs, which moves a cancelling sum by an ulp of its
terms)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core import updaters as ju
from large_scale_recommendation_tpu_torch.core import updaters as tu

SCHEDULES = [
    ("inverse_sqrt", {}), ("default", {}), ("constant", {}),
    ("inv_scaling", {}), ("inv_scaling", {"decay": 0.3}),
    ("bottou", {}), ("bottou", {"optimal_init": 40.0}),
    ("xu", {}), ("xu", {"decay": -0.5}),
    ("warm_boost", {}), ("warm_boost", {"boost_factor": 3.0,
                                        "boost_steps": 4}),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
@pytest.mark.parametrize("base_lr", [0.3, 0.001])
def test_schedule_parity(name, kw, base_lr):
    fj = ju.schedule_from_name(name, 0.1, **kw)
    ft = tu.schedule_from_name(name, 0.1, **kw)
    for t in range(1, 13):
        want = float(fj(jnp.float32(base_lr), jnp.float32(t)))
        got = ft(base_lr, t)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_errors_and_identity():
    with pytest.raises(ValueError, match="unknown"):
        tu.schedule_from_name("cosine")
    with pytest.raises(ValueError, match="lambda"):
        tu.schedule_from_name("bottou", 0.0)
    assert tu.warm_boost_lr() is tu.warm_boost_lr(2.5, 2)
    assert tu.schedule_from_name("warm_boost")(0.3, 2) == pytest.approx(0.75)
    assert tu.schedule_from_name("warm_boost")(0.3, 3) == pytest.approx(0.3)


def _batch(seed, b=64, r=16):
    rng = np.random.default_rng(seed)
    ratings = rng.normal(0, 1, b).astype(np.float32)
    u = rng.normal(0, 0.3, (b, r)).astype(np.float32)
    v = rng.normal(0, 0.3, (b, r)).astype(np.float32)
    w = (rng.random(b) > 0.2).astype(np.float32)
    ou = rng.integers(0, 6, b).astype(np.float32)
    ov = rng.integers(0, 6, b).astype(np.float32)
    return ratings, u, v, w, ou, ov


@pytest.mark.parametrize("sched", ["inverse_sqrt", "warm_boost", "bottou"])
@pytest.mark.parametrize("with_omega", [True, False])
@pytest.mark.parametrize("t", [1, 3, 9])
def test_regularized_delta_parity(sched, with_omega, t):
    ratings, u, v, w, ou, ov = _batch(t)
    kw = dict(learning_rate=0.05, lambda_=0.1)
    jd = ju.RegularizedSGDUpdater(**kw, schedule=ju.schedule_from_name(
        sched, 0.1)).delta(
        jnp.asarray(ratings), jnp.asarray(u), jnp.asarray(v),
        weights=jnp.asarray(w),
        omega_u=jnp.asarray(ou) if with_omega else None,
        omega_v=jnp.asarray(ov) if with_omega else None, t=t)
    td = tu.RegularizedSGDUpdater(**kw, schedule=tu.schedule_from_name(
        sched, 0.1)).delta(
        torch.from_numpy(ratings), torch.from_numpy(u), torch.from_numpy(v),
        weights=torch.from_numpy(w),
        omega_u=torch.from_numpy(ou) if with_omega else None,
        omega_v=torch.from_numpy(ov) if with_omega else None, t=t)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-8)
    # padding rows contribute exactly zero
    assert (td[0].numpy()[w == 0] == 0).all()


@pytest.mark.parametrize("t", [1, 4])
def test_plain_sgd_delta_and_next_factors(t):
    ratings, u, v, w, _, _ = _batch(10 + t)
    jupd = ju.SGDUpdater(learning_rate=0.02, schedule=ju.inverse_sqrt_lr)
    tupd = tu.SGDUpdater(learning_rate=0.02, schedule=tu.inverse_sqrt_lr)
    jn = jupd.next_factors(jnp.asarray(ratings), jnp.asarray(u),
                           jnp.asarray(v), weights=jnp.asarray(w), t=t)
    tn = tupd.next_factors(torch.from_numpy(ratings), torch.from_numpy(u),
                           torch.from_numpy(v), weights=torch.from_numpy(w),
                           t=t)
    for a, b in zip(jn, tn):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-8)
    # the regularized rule without weights or omegas (plain λ)
    jr = ju.RegularizedSGDUpdater().delta(
        jnp.asarray(ratings), jnp.asarray(u), jnp.asarray(v), t=t)
    tr = tu.RegularizedSGDUpdater().delta(
        torch.from_numpy(ratings), torch.from_numpy(u), torch.from_numpy(v),
        t=t)
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("with_omega", [True, False])
def test_regularized_next_factors_parity(with_omega):
    ratings, u, v, w, ou, ov = _batch(21)
    kw = dict(learning_rate=0.05, lambda_=0.1)
    jn = ju.RegularizedSGDUpdater(**kw).next_factors(
        jnp.asarray(ratings), jnp.asarray(u), jnp.asarray(v),
        weights=jnp.asarray(w),
        omega_u=jnp.asarray(ou) if with_omega else None,
        omega_v=jnp.asarray(ov) if with_omega else None, t=3)
    tn = tu.RegularizedSGDUpdater(**kw).next_factors(
        torch.from_numpy(ratings), torch.from_numpy(u), torch.from_numpy(v),
        weights=torch.from_numpy(w),
        omega_u=torch.from_numpy(ou) if with_omega else None,
        omega_v=torch.from_numpy(ov) if with_omega else None, t=3)
    for a, b in zip(jn, tn):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-8)
    # padding rows keep their factors exactly
    np.testing.assert_array_equal(tn[0].numpy()[w == 0], u[w == 0])
