"""The slice as a whole: the port's ``DSGD(device="cpu").fit`` against the
JAX package's ``DSGD(kernel="pallas").fit`` (interpret mode on the CPU),
from the same initial tables (carried across with ``convert``), fitted as
two segments. Final tables: rtol 2e-4 / atol 2e-5 (the JAX package's own
bound between its two routes); RMSE and empirical risk to 1e-5."""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JConfig
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.types import Ratings
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
    solver._init_factors = lambda _problem: convert.factors_from_jax(U0, V0)
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
                                jmodel.users, jmodel.items)
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
        t, _ = convert.factors_from_jax(src, src)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      Ub.astype(np.float32))
    with pytest.raises(ValueError, match="dtype"):
        convert.factors_from_jax(np.zeros((2, 2)), np.zeros((2, 2)))


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
