"""The framework-free rest of the core contract, against the JAX package:
``FunctionFactorInitializer`` and ``init_table``, ``MockFactorUpdater``,
``ThroughputLimiter``, ``merge_config`` / ``config_to_dict``."""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core import initializers as jinit
from large_scale_recommendation_tpu.core import updaters as jupd
from large_scale_recommendation_tpu.core.limiter import (
    ThroughputLimiter as JLimiter,
)
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JConfig
from large_scale_recommendation_tpu.utils import config as jconfig
from large_scale_recommendation_tpu_torch.core import initializers as tinit
from large_scale_recommendation_tpu_torch.core import updaters as tupd
from large_scale_recommendation_tpu_torch.core.limiter import (
    ThroughputLimiter,
)
from large_scale_recommendation_tpu_torch.models.dsgd import DSGDConfig
from large_scale_recommendation_tpu_torch.utils import config as tconfig


def test_function_initializer_and_init_table():
    def fn_np(ids):
        ids = np.asarray(ids, np.float32)
        return np.stack([ids * 0.5, ids + 1.0], axis=1)

    jt = jinit.init_table(jinit.FunctionFactorInitializer(
        2, lambda ids: jnp.asarray(fn_np(ids))), 7)
    init = tinit.FunctionFactorInitializer(
        2, lambda ids: torch.from_numpy(fn_np(ids.numpy())))
    assert init.open() is init and init.rank == 2
    tt = tinit.init_table(init, 7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the keyed initializer through init_table: row j is id j's row
    keyed = tinit.PseudoRandomFactorInitializer(4, scale=0.5)
    table = tinit.init_table(keyed, 5, rank=4)
    assert torch.equal(table, keyed(torch.arange(5)))
    assert tinit.init_table(keyed, 0).shape == (0, 4)


@pytest.mark.parametrize("weights", [False, True])
def test_mock_updater_matches_jax(weights):
    rng = np.random.default_rng(0)
    r = rng.normal(size=6).astype(np.float32)
    u = rng.normal(size=(6, 3)).astype(np.float32)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    w = np.ones(6, np.float32) if weights else None
    jm, tm = jupd.MockFactorUpdater(), tupd.MockFactorUpdater()
    jdu, jdv = jm.delta(r, u, v, weights=w, t=3)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    du, dv = tm.delta(torch.from_numpy(r), tu, tv,
                      weights=None if w is None else torch.from_numpy(w), t=3)
    np.testing.assert_array_equal(du.numpy(), np.asarray(jdu))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(jdv))
    nu, nv = tm.next_factors(torch.from_numpy(r), tu, tv)
    assert nu is tu and nv is tv
    ju, jv = jm.next_factors(r, u, v)
    np.testing.assert_array_equal(nu.numpy(), np.asarray(ju))


def test_throughput_limiter_paces_like_jax():
    lim = ThroughputLimiter(let_through=5, per_millisec=20)
    jlim = JLimiter(let_through=5, per_millisec=20)
    t0 = time.monotonic()
    for j in range(12):
        assert lim.emit_or_wait(j) == j
    elapsed = time.monotonic() - t0
    # the 6th element sleeps out the first 20 ms window; the next window
    # opens at that element's arrival, so the 12th waits for nothing
    assert elapsed >= 0.015
    lim.emit_batch_or_wait(11)
    jlim.emit_batch_or_wait(11)
    assert (lim._cnt, lim.let_through) == (jlim._cnt, jlim.let_through)


def test_merge_config_and_config_to_dict():
    base = DSGDConfig(num_factors=64, iterations=10)
    cfg = tconfig.merge_config(base, {"iterations": 5},
                               {"learning_rate": 0.1}, seed=1)
    assert (cfg.num_factors, cfg.iterations, cfg.learning_rate,
            cfg.seed) == (64, 5, 0.1, 1)
    assert base.iterations == 10  # never mutated
    jcfg = jconfig.merge_config(JConfig(num_factors=64, iterations=10),
                                {"iterations": 5}, {"learning_rate": 0.1},
                                seed=1)
    td, jd = tconfig.config_to_dict(cfg), jconfig.config_to_dict(jcfg)
    assert {k: v for k, v in jd.items() if k in td} == td
    other = DSGDConfig(num_factors=3)
    assert tconfig.merge_config(base, other) is other
    with pytest.raises(ValueError, match="unknown config key"):
        tconfig.merge_config(base, {"kernel": "pallas"})
    with pytest.raises(TypeError, match="cannot merge"):
        tconfig.merge_config(base, JConfig())
    with pytest.raises(TypeError, match="dataclass"):
        tconfig.merge_config({"a": 1}, {})


@pytest.mark.parametrize("name,kw", [("RandomFactorInitializer",
                                      dict(rank=3, seed=2, salt=1)),
                                     ("PseudoRandomFactorInitializer",
                                      dict(rank=3, scale=0.5))])
def test_initializer_open_is_identity_like_jax(name, kw):
    """``open()`` returns the initializer itself in both packages (the
    descriptor/open split of the reference's API)."""
    jobj, tobj = getattr(jinit, name)(**kw), getattr(tinit, name)(**kw)
    assert jobj.open() is jobj
    assert tobj.open() is tobj
    ids = np.arange(5)
    assert tuple(tobj.open()(ids).shape) == np.asarray(jobj(ids)).shape
