"""The slice as a whole: the port's ``DSGD(device="cpu").fit`` against the
JAX package's ``DSGD(kernel="pallas").fit`` (interpret mode on the CPU),
from the same initial tables (carried across with ``convert``), fitted as
two segments. Final tables: rtol 2e-4 / atol 2e-5 (the JAX package's own
bound between its two routes); RMSE and empirical risk to 1e-5.

``fit_device`` and bf16 storage: the port's CPU route against the JAX
package's ``kernel="xla"`` route, which rounds bf16 tables at the same
points (once per ``dsgd_train`` call, so once per segment). The device
layout comes from JAX's permutations (bit-equal, see
tests/test_torch_device_blocking.py) and the initial tables from JAX.
bf16 bars: tables within 2 bf16 ulps, RMSE to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.data import device_blocking as jdb
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JConfig
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data import device_blocking
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.ops import cuda_sgd

CASES = {
    "uniform_k2": dict(skew=None, k=2, schedule="inverse_sqrt", sort=None),
    "skewed_k4": dict(skew=2.0, k=4, schedule="inverse_sqrt", sort=None),
    "skewed_k2_warm_boost": dict(skew=2.0, k=2, schedule="warm_boost",
                                 sort="item"),
}


def _kw(case):
    return dict(num_factors=8, lambda_=0.05, iterations=4, learning_rate=0.05,
                lr_schedule=case["schedule"], seed=0, minibatch_size=128,
                init_scale=0.3, minibatch_sort=case["sort"])


def _port_ratings(r):
    return Ratings.from_arrays(*r.to_numpy())


def _fit_pair(name):
    case = CASES[name]
    gen = SyntheticMFGenerator(num_users=64, num_items=48, rank=4, noise=0.1,
                               seed=1, skew_lam=case["skew"])
    train, test = gen.generate(3000), gen.generate(500)
    k, kw = case["k"], _kw(case)
    jsolver = JDSGD(JConfig(**kw, kernel="pallas"))
    jmodel = jsolver.fit(train, num_blocks=k, checkpoint_every=2)
    problem = jblk.block_problem(train, num_blocks=k, seed=0,
                                 minibatch_multiple=128,
                                 minibatch_sort=case["sort"])
    U0, V0 = (np.asarray(a) for a in jsolver._init_factors(problem))

    solver = DSGD(DSGDConfig(**kw), device="cpu")
    # the seam: the JAX tables replace the port's own (Philox ≠ threefry)
    solver._init_factors = lambda _problem: convert.factors_from_jax(
        U0, V0, device="cpu")
    model = solver.fit(_port_ratings(train), num_blocks=k, checkpoint_every=2)
    return jsolver, jmodel, solver, model, train, test


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_matches_jax_pallas_fit(name):
    jsolver, jmodel, solver, model, train, test = _fit_pair(name)
    np.testing.assert_array_equal(model.users.ids, jmodel.users.ids)
    np.testing.assert_array_equal(model.items.ids, jmodel.items.ids)
    for a, b in ((model.U, jmodel.U), (model.V, jmodel.V)):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    tt = _port_ratings(test)
    assert abs(model.rmse(tt) - jmodel.rmse(test)) < 1e-5
    assert model.rmse(tt) < 0.5  # it learned something
    np.testing.assert_allclose(solver.empirical_risk(tt),
                               jsolver.empirical_risk(test), rtol=1e-5)


def test_predict_unseen_ids_and_mask():
    jsolver, jmodel, solver, model, train, test = _fit_pair("uniform_k2")
    users = np.array([0, 5, 10**6, 7, -3])
    items = np.array([1, 10**6, 2, 3, 4])
    s, seen = solver.predict(users, items, return_mask=True)
    js, jseen = jmodel.predict(users, items, return_mask=True)
    np.testing.assert_array_equal(seen, np.asarray(jseen))
    assert seen.dtype == bool and seen.tolist() == [True, False, False,
                                                     True, False]
    assert (s[~seen] == 0.0).all()
    np.testing.assert_allclose(s, np.asarray(js), rtol=2e-4, atol=2e-5)
    assert solver.predict(users, items).shape == (5,)


def test_model_from_jax_scores_like_the_jax_model():
    _, jmodel, _, _, _, test = _fit_pair("skewed_k4")
    pm = convert.model_from_jax(np.asarray(jmodel.U), np.asarray(jmodel.V),
                                jmodel.users, jmodel.items, device="cpu")
    tt = _port_ratings(test)
    assert abs(pm.rmse(tt) - jmodel.rmse(test)) < 1e-5
    np.testing.assert_allclose(pm.empirical_risk(tt, 0.05),
                               jmodel.empirical_risk(test, 0.05), rtol=1e-5)
    np.testing.assert_allclose(
        pm.predict(test.users, test.items),
        np.asarray(jmodel.predict(test.users, test.items)),
        rtol=1e-5, atol=1e-6)
    pu = list(pm.user_factors())
    ju = list(jmodel.user_factors())
    assert [f.id for f in pu] == [f.id for f in ju]
    np.testing.assert_array_equal(pu[3].factors, ju[3].factors)
    assert len(list(pm.item_factors())) == len(list(jmodel.item_factors()))


def test_factors_from_jax_bf16_bit_views():
    import jax.numpy as jnp

    U = jnp.asarray(np.linspace(-1, 1, 24, dtype=np.float32).reshape(6, 4))
    Ub = np.asarray(U.astype(jnp.bfloat16))
    for src in (Ub, Ub.view(np.uint16)):
        t, _ = convert.factors_from_jax(src, src, device="cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      Ub.astype(np.float32))
    with pytest.raises(ValueError, match="dtype"):
        convert.factors_from_jax(np.zeros((2, 2)), np.zeros((2, 2)),
                                 device="cpu")


def test_error_paths():
    empty = Ratings.from_arrays([], [], [])
    with pytest.raises(ValueError, match="empty"):
        DSGD(DSGDConfig(), device="cpu").fit(empty)
    unfitted = DSGD(DSGDConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        unfitted.predict([1], [2])
    with pytest.raises(RuntimeError, match="fit"):
        unfitted.empirical_risk(empty)
    # what a CUDA-device fit refuses before it blocks anything
    for cfg in (DSGDConfig(collision_mode="sum"),
                DSGDConfig(precompute_collisions=False)):
        solver = DSGD(cfg, device="cpu")
        with pytest.raises(ValueError, match="collision"):
            cuda_sgd.validate_cuda_contract(
                solver.updater, cfg.collision_mode,
                cfg.precompute_collisions and cfg.collision_mode == "mean")


def test_cpu_fit_honours_collision_modes():
    """On the CPU the plain route keeps every collision mode."""
    gen = SyntheticMFGenerator(num_users=32, num_items=24, rank=2,
                               noise=0.1, seed=0)
    train = _port_ratings(gen.generate(600))
    fits = {}
    for mode, pre in (("mean", True), ("mean", False), ("sum", True)):
        cfg = DSGDConfig(num_factors=4, iterations=2, learning_rate=0.05,
                         lambda_=0.05, minibatch_size=64, init_scale=0.3,
                         collision_mode=mode, precompute_collisions=pre)
        fits[(mode, pre)] = DSGD(cfg, device="cpu").fit(train, num_blocks=2)
    # precomputed and runtime collision counts are the same math
    np.testing.assert_allclose(fits[("mean", True)].U.numpy(),
                               fits[("mean", False)].U.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(fits[("mean", True)].U.numpy(),
                           fits[("sum", True)].U.numpy())


def bf16_ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0 ** 16


def _tables_close(port, jax_tables, dtype):
    for a, b in zip(port, jax_tables):
        b = np.asarray(b, np.float32)
        if dtype == "bfloat16":
            assert a.dtype == torch.bfloat16
            a = a.float().numpy()
            bound = 2 * np.maximum(bf16_ulp(a), bf16_ulp(b))
            assert (np.abs(a - b) <= bound).all(), float(np.abs(a - b).max())
        else:
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-5)


def _dense(seed, n, nu=64, ni=48, rank=4):
    """Dense-id planted ratings (numpy): skewed ids, rank-4 truth, noise
    0.1; train and holdout draws."""
    rng = np.random.default_rng(seed)
    Ut = rng.normal(0, 0.5, (nu, rank)).astype(np.float32)
    Vt = rng.normal(0, 0.5, (ni, rank)).astype(np.float32)

    def draw(m):
        u = np.minimum(rng.exponential(nu / 3, m), nu - 1).astype(np.int32)
        i = np.minimum(rng.exponential(ni / 3, m), ni - 1).astype(np.int32)
        r = ((Ut[u] * Vt[i]).sum(-1) + rng.normal(0, 0.1, m)).astype(
            np.float32)
        return u, i, r

    return draw(n), draw(500), (nu, ni)


def _fit_device_pair(dtype, sort, k=2):
    (u, i, r), hold, (nu, ni) = _dense(3, 3000)
    kw = dict(num_factors=8, lambda_=0.05, iterations=4, learning_rate=0.05,
              lr_schedule="warm_boost", seed=0, minibatch_size=128,
              init_scale=0.3, minibatch_sort=sort, factor_dtype=dtype)
    jmodel = JDSGD(JConfig(**kw, kernel="xla")).fit_device(
        u, i, r, nu, ni, num_blocks=k, checkpoint_every=2)
    jp = jdb.device_block_problem(u, i, r, nu, ni, num_blocks=k,
                                  minibatch_multiple=128, seed=0,
                                  minibatch_sort=sort)
    U0, V0 = (np.asarray(a) for a in jdb.init_factors_device(jp, 8, 0.3))
    base = jax.random.PRNGKey(0)
    perms = tuple(np.asarray(jax.random.permutation(
        jax.random.fold_in(base, salt), m))
        for salt, m in ((10, nu), (11, ni), (12, len(u))))
    return jmodel, jp, (U0, V0), perms, kw, (u, i, r), hold, (nu, ni)


@pytest.mark.parametrize("dtype,sort", [("float32", None),
                                        ("float32", "item"),
                                        ("bfloat16", None),
                                        ("bfloat16", "item")])
def test_fit_device_matches_jax_xla_fit_device(monkeypatch, dtype, sort):
    jmodel, jp, (U0, V0), perms, kw, (u, i, r), (hu, hi, hr), (nu, ni) = \
        _fit_device_pair(dtype, sort)
    # the two seams: JAX's draws and JAX's initial tables
    monkeypatch.setattr(device_blocking, "draw_permutations",
                        lambda *a, **k: perms)
    solver = DSGD(DSGDConfig(**kw), device="cpu")
    solver._init_factors_device = \
        lambda _p: convert.factors_from_jax(U0, V0, device="cpu")
    model = solver.fit_device(u, i, r, nu, ni, num_blocks=2,
                              checkpoint_every=2)
    _tables_close((model.U, model.V), (jmodel.U, jmodel.V), dtype)
    for a, b in zip((model.users, model.items), (jmodel.users, jmodel.items)):
        np.testing.assert_array_equal(a.ids, b.ids)
    test = (Ratings.from_arrays(hu, hi, hr), JRatings.from_arrays(hu, hi, hr))
    bar = 1e-5 if dtype == "float32" else 1e-4
    assert abs(model.rmse(test[0]) - jmodel.rmse(test[1])) < bar
    assert model.rmse(test[0]) < 0.6  # it learned something
    # the layout seam gives the same fit from JAX's own problem
    again = DSGD(DSGDConfig(**kw), device="cpu")
    again._init_factors_device = solver._init_factors_device
    m2 = again._fit_problem(convert.device_problem_from_jax(jp, device="cpu"),
                            checkpoint_every=2)
    assert torch.equal(m2.U, model.U) and torch.equal(m2.V, model.V)


def test_fit_bf16_matches_jax_xla_fit():
    gen = SyntheticMFGenerator(num_users=64, num_items=48, rank=4, noise=0.1,
                               seed=1, skew_lam=2.0)
    train, test = gen.generate(3000), gen.generate(500)
    kw = dict(_kw(CASES["skewed_k4"]), factor_dtype="bfloat16")
    jsolver = JDSGD(JConfig(**kw, kernel="xla"))
    jmodel = jsolver.fit(train, num_blocks=4, checkpoint_every=2)
    problem = jblk.block_problem(train, num_blocks=4, seed=0,
                                 minibatch_multiple=128)
    U0, V0 = (np.asarray(a) for a in jsolver._init_factors(problem))
    solver = DSGD(DSGDConfig(**kw), device="cpu")
    solver._init_factors = lambda _problem: convert.factors_from_jax(
        U0, V0, device="cpu")
    model = solver.fit(_port_ratings(train), num_blocks=4, checkpoint_every=2)
    _tables_close((model.U, model.V), (jmodel.U, jmodel.V), "bfloat16")
    assert abs(model.rmse(_port_ratings(test)) - jmodel.rmse(test)) < 1e-4
    # bf16 tracks the f32 fit (the JAX package's own 5% bar)
    f32 = DSGD(DSGDConfig(**_kw(CASES["skewed_k4"])), device="cpu")
    f32._init_factors = solver._init_factors
    r32 = f32.fit(_port_ratings(train), num_blocks=4).rmse(
        _port_ratings(test))
    assert abs(model.rmse(_port_ratings(test)) - r32) < 0.05 * r32


def test_unknown_factor_dtype_raises_like_jax():
    gen = SyntheticMFGenerator(num_users=16, num_items=12, rank=2,
                               noise=0.1, seed=0)
    train = gen.generate(200)
    cfg = dict(num_factors=4, iterations=1, factor_dtype="float16")
    with pytest.raises(ValueError, match="factor_dtype"):
        JDSGD(JConfig(**cfg)).fit(train, num_blocks=1)
    solver = DSGD(DSGDConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="factor_dtype"):
        solver.fit(_port_ratings(train), num_blocks=1)
    u, i, r = (np.asarray(a) for a in _port_ratings(train).to_numpy()[:3])
    with pytest.raises(ValueError, match="factor_dtype"):
        solver.fit_device(u, i, r, 16, 12, num_blocks=1)


def test_fit_device_own_draws_and_keyed_init():
    """Without seams: the port's own blocking draws and the keyed init,
    which gives each id the row the host fit's init gives it."""
    (u, i, r), (hu, hi, hr), (nu, ni) = _dense(4, 3000)
    cfg = DSGDConfig(num_factors=8, lambda_=0.05, iterations=4,
                     learning_rate=0.05, lr_schedule="warm_boost",
                     minibatch_size=128, init_scale=0.3)
    dev_solver = DSGD(cfg, device="cpu")
    problem = device_blocking.device_block_problem(
        u, i, r, nu, ni, num_blocks=2, minibatch_multiple=128, seed=0,
        device="cpu")
    Ud, _ = dev_solver._init_factors_device(problem)
    host = jblk.block_problem(JRatings.from_arrays(u, i, r), num_blocks=2,
                              seed=0, minibatch_multiple=128)
    Uh, _ = DSGD(cfg, device="cpu")._init_factors(host)
    ids = np.arange(nu)
    rows_d = problem.row_of_user.long().numpy()[ids]
    rows_h, _ = host.users.rows_for(ids)
    np.testing.assert_array_equal(Ud.numpy()[rows_d], Uh.numpy()[rows_h])
    model = dev_solver.fit_device(torch.from_numpy(u), torch.from_numpy(i),
                                  torch.from_numpy(r), nu, ni, num_blocks=2,
                                  checkpoint_every=1)
    hold = Ratings.from_arrays(hu, hi, hr)
    assert model.rmse(hold) < 0.6
    assert model.U.shape == (problem.omega_u.shape[0], 8)
    host_fit = DSGD(cfg, device="cpu").fit(Ratings.from_arrays(u, i, r),
                                           num_blocks=2)
    # other layouts, the same learning problem
    assert abs(model.rmse(hold) - host_fit.rmse(hold)) < 0.05
