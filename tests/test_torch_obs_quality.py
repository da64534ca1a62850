"""The port's ``OnlineEvaluator`` against the JAX package's: the same
batches split draw for draw (the same numpy generators: ``seed`` for the
split, ``seed + 1`` for the evaluation), and the ``eval_*`` gauges of
``evaluate`` (a JAX online model carried across by ``convert``) and of
the segment hook ``on_segment`` (the same tables) within 1e-5 relative —
f32 sums in other orders; the ranking metrics draw the same negatives, so
HR matches exactly but for a near-tie."""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.models.online import (
    OnlineMF as JOnlineMF,
    OnlineMFConfig as JOnlineMFConfig,
)
from large_scale_recommendation_tpu.obs import quality as jq
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.obs import quality as pq
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.utils import metrics

RTOL = 1e-5


def _batches(seed, n_batches=6, n=400, users=80, items=50):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        u = rng.integers(0, users, n)
        i = rng.integers(0, items, n)
        v = (rng.normal(size=n) + 3.0).astype(np.float32)
        w = (rng.random(n) > 0.1).astype(np.float32)
        yield u, i, v, w


def test_reexports_are_the_metrics_functions():
    assert pq.sampled_ranking_metrics is metrics.sampled_ranking_metrics
    assert pq.catalog_coverage is metrics.catalog_coverage
    assert obs.OnlineEvaluator is pq.OnlineEvaluator


@pytest.mark.parametrize("seed", range(3))
def test_splits_equal_jax_draw_for_draw(seed):
    j = jq.OnlineEvaluator(holdout_fraction=0.2, reservoir_size=300,
                           seed=seed, registry=jreg.MetricsRegistry())
    p = pq.OnlineEvaluator(holdout_fraction=0.2, reservoir_size=300,
                           seed=seed, registry=MetricsRegistry())
    for u, i, v, w in _batches(seed):
        jw = j.split_batch(JRatings.from_arrays(u, i, v, w)).to_numpy()[3]
        pw = p.split_batch(Ratings.from_arrays(u, i, v, w)).to_numpy()[3]
        np.testing.assert_array_equal(pw, jw)
    assert p.snapshot() == j.snapshot()
    for f in ("_res_u", "_res_i", "_res_v"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
    assert p._eval_rng.random() == j._eval_rng.random()


def test_bad_arguments_raise_like_jax():
    for mod in (jq, pq):
        with pytest.raises(ValueError):
            mod.OnlineEvaluator(holdout_fraction=1.0)
        with pytest.raises(ValueError):
            mod.OnlineEvaluator(reservoir_size=0)
        assert mod.OnlineEvaluator().evaluate() is None
        assert mod.OnlineEvaluator().on_segment(None, None) is None


def _gauges(reg):
    return {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in reg.snapshot()["metrics"] if m["type"] == "gauge"}


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=RTOL, abs=1e-7), k


@pytest.mark.parametrize("seed", range(2))
def test_evaluate_gauges_within_rtol_of_jax(seed):
    """A JAX online model trains on the batches the JAX evaluator split;
    ``convert.online_from_jax`` carries it across; both evaluators score
    the same reservoir."""
    cfg = JOnlineMFConfig(num_factors=8, minibatch_size=128,
                          learning_rate=0.05)
    jm = JOnlineMF(cfg)
    jr, pr = jreg.MetricsRegistry(), MetricsRegistry()
    j = jq.OnlineEvaluator(jm, holdout_fraction=0.2, seed=seed,
                           min_eval_rows=8, eval_sample=64,
                           num_negatives=20, registry=jr)
    p = pq.OnlineEvaluator(None, holdout_fraction=0.2, seed=seed,
                           min_eval_rows=8, eval_sample=64,
                           num_negatives=20, registry=pr)
    for u, i, v, w in _batches(seed):
        jm.partial_fit(j.split_batch(JRatings.from_arrays(u, i, v, w)))
        p.split_batch(Ratings.from_arrays(u, i, v, w))
    p.model = convert.online_from_jax(jm, device="cpu")
    jout, pout = j.evaluate(), p.evaluate()
    assert pout["n"] == jout["n"] and pout["ranked"] == jout["ranked"]
    for k in ("rmse", "ndcg", "hr", "coverage", "valid_negatives"):
        assert pout[k] == pytest.approx(jout[k], rel=RTOL), k
    _close(_gauges(pr), _gauges(jr))
    assert pr.counter("eval_runs_total", source="online").value == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_on_segment_within_rtol_of_jax(dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    U = (0.3 * rng.normal(size=(90, 8))).astype(np.float32)
    V = (0.3 * rng.normal(size=(40, 8))).astype(np.float32)
    n = 500
    hold = (rng.integers(0, 90, n), rng.integers(0, 40, n),
            rng.normal(size=n).astype(np.float32))
    mask = rng.random(40) > 0.1
    jr, pr = jreg.MetricsRegistry(), MetricsRegistry()
    j = jq.OnlineEvaluator(seed=3, eval_sample=128, registry=jr)
    p = pq.OnlineEvaluator(seed=3, eval_sample=128, registry=pr)
    j.set_offline_holdout(*hold, item_mask=mask)
    p.set_offline_holdout(*hold, item_mask=mask)
    tdt = getattr(torch, dtype)
    jout = j.on_segment(jnp.asarray(U).astype(dtype),
                        jnp.asarray(V).astype(dtype), label="seg", step=2)
    pout = p.on_segment(torch.from_numpy(U).to(tdt),
                        torch.from_numpy(V).to(tdt), label="seg", step=2)
    for k in ("rmse", "ndcg", "hr"):
        assert pout[k] == pytest.approx(jout[k], rel=RTOL), k
    assert pout["step"] == jout["step"] == 2
    _close(_gauges(pr), _gauges(jr))


def test_start_runs_evaluate_on_a_cadence():
    class Model:
        calls = 0

    ev = pq.OnlineEvaluator(registry=MetricsRegistry())
    ev.model = Model()
    ev.evaluate = lambda: setattr(Model, "calls", Model.calls + 1)
    ev.start(0.01)
    import time

    deadline = time.time() + 10
    while Model.calls < 2 and time.time() < deadline:
        time.sleep(0.01)
    ev.stop()
    assert Model.calls >= 2 and not ev.running
