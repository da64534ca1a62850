"""Top-K serving and ranking quality: the port's ``utils.metrics`` and
``MFModel.recommend`` / ``recommend_users`` / ``ranking_quality`` against
the JAX package's on the same tables (carried across with
``convert.model_from_jax``), in f32 and bf16.

Bars: scores rtol 1e-5 / atol 1e-6 (the two matmuls sum in other orders);
ids equal wherever a score differs from its neighbours by more than that,
tie groups compared as sets (a group cut by the k-th place only by its
scores); HR/NDCG within 1e-6 in f32 and 2e-3 in bf16 (one dot summed to
the other side of a neighbour's moves one rank)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.mf import MFModel as JMFModel
from large_scale_recommendation_tpu.utils import metrics as jmetrics
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.utils import metrics

RTOL, ATOL = 1e-5, 1e-6
HR_TOL = {"float32": 1e-6, "bfloat16": 2e-3}


def _models(dtype, seed=1, rank=8):
    gen = SyntheticMFGenerator(num_users=64, num_items=48, rank=4, noise=0.1,
                               seed=seed, skew_lam=2.0)
    train, test = gen.generate(2000), gen.generate(400)
    p = jblk.block_problem(train, num_blocks=2, seed=0)  # padded rows too
    rng = np.random.default_rng(seed)
    U = jnp.asarray(rng.normal(0, 0.5, (p.users.num_rows, rank)), jnp.float32)
    V = jnp.asarray(rng.normal(0, 0.5, (p.items.num_rows, rank)), jnp.float32)
    if dtype == "bfloat16":
        U, V = U.astype(jnp.bfloat16), V.astype(jnp.bfloat16)
    jm = JMFModel(U=U, V=V, users=p.users, items=p.items)
    tm = convert.model_from_jax(np.asarray(U), np.asarray(V), p.users,
                                p.items, device="cpu")
    return jm, tm, train, test


def assert_topk_match(ids, scores, jids, jscores):
    """Scores at tolerance position by position; ids equal outside tie
    groups, tie groups equal as sets unless cut by the k-th place."""
    jids, jscores = np.asarray(jids), np.asarray(jscores)
    assert ids.shape == jids.shape and scores.dtype == np.float32
    np.testing.assert_allclose(scores, jscores, rtol=RTOL, atol=ATOL)
    k = ids.shape[1]
    for r in range(ids.shape[0]):
        s = jscores[r]
        close = np.isclose(s[1:], s[:-1], rtol=RTOL, atol=ATOL)
        start = 0
        for p in range(1, k + 1):
            if p < k and close[p - 1]:
                continue
            group = slice(start, p)
            if p - start == 1:
                assert ids[r, start] == jids[r, start], (r, start)
            elif p < k:
                assert set(ids[r, group]) == set(jids[r, group]), (r, group)
            start = p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,dup,mask", [(10, False, True), (5, True, True),
                                        (3, True, False), (80, True, True)])
def test_top_k_recommend_matches_jax(dtype, k, dup, mask):
    jm, tm, train, _ = _models(dtype)
    tu, ti = tm._train_rows(train)
    if dup:  # duplicate train pairs: the exclusion is idempotent
        tu, ti = np.concatenate([tu, tu[:300]]), np.concatenate([ti, ti[:300]])
    item_mask = tm.items.ids >= 0 if mask else None
    rows = np.arange(tm.U.shape[0])[::3]
    got = metrics.top_k_recommend(tm.U, tm.V, rows, k=k, train_u=tu,
                                  train_i=ti, chunk=7, item_mask=item_mask)
    want = jmetrics.top_k_recommend(jm.U, jm.V, rows, k=k, train_u=tu,
                                    train_i=ti, chunk=7, item_mask=item_mask)
    assert got[0].dtype == np.int32
    if k > tm.V.shape[0]:  # k above the catalog: -inf slots past it
        assert np.isneginf(got[1][:, tm.V.shape[0]:]).all()
        finite = slice(0, tm.V.shape[0])
        assert_topk_match(got[0][:, finite], got[1][:, finite],
                          want[0][:, finite], want[1][:, finite])
    else:
        assert_topk_match(*got, *want)
    # no excluded slot surfaces above the dead-slot threshold
    tset = set(zip(tu.tolist(), ti.tolist()))
    for r, u in enumerate(rows):
        live = got[1][r] > metrics.DEAD_SLOT_THRESHOLD
        assert not any((u, c) in tset for c in got[0][r][live])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,with_train,dup", [(10, True, False),
                                              (5, True, True),
                                              (20, False, False)])
def test_ranking_metrics_match_jax(dtype, k, with_train, dup):
    jm, tm, train, test = _models(dtype, seed=2)
    eu, _ = tm.users.rows_for(test.users)
    ei, _ = tm.items.rows_for(test.items)
    tu = ti = None
    if with_train:
        tu, ti = tm._train_rows(train)
        if dup:
            tu, ti = np.concatenate([tu, tu]), np.concatenate([ti, ti])
    kw = dict(k=k, train_u=tu, train_i=ti, chunk=64,
              item_mask=tm.items.ids >= 0)
    got = metrics.ranking_metrics(tm.U, tm.V, eu, ei, **kw)
    want = jmetrics.ranking_metrics(jm.U, jm.V, eu, ei, **kw)
    assert got["n"] == want["n"] == len(eu)
    assert abs(got["hr"] - want["hr"]) <= HR_TOL[dtype]
    assert abs(got["ndcg"] - want["ndcg"]) <= HR_TOL[dtype]
    assert 0.0 < got["hr"] <= 1.0


def test_empty_inputs():
    _, tm, _, _ = _models("float32")
    r = metrics.ranking_metrics(tm.U, tm.V, [], [])
    assert r["n"] == 0 and np.isnan(r["hr"]) and np.isnan(r["ndcg"])
    rows, scores = metrics.top_k_recommend(tm.U, tm.V, [], k=4)
    assert rows.shape == scores.shape == (0, 4)
    ids, sc = tm.recommend([], k=3)
    assert ids.shape == (0, 3) and sc.dtype == np.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_recommend_matches_jax(dtype):
    jm, tm, train, test = _models(dtype, seed=3)
    users = np.concatenate([test.users[:40], [10**6, -5]])
    tr = Ratings.from_arrays(*train.to_numpy())
    pairs = (train.users, train.items)
    for kw, jkw in ((dict(k=10), dict(k=10)),
                    (dict(k=6, train=tr), dict(k=6, train=train)),
                    (dict(k=6, train=pairs), dict(k=6, train=pairs)),
                    (dict(k=100, train=tr), dict(k=100, train=train))):
        ids, scores, known = tm.recommend(users, return_mask=True, **kw)
        jids, jscores, jknown = jm.recommend(users, return_mask=True, **jkw)
        np.testing.assert_array_equal(known, np.asarray(jknown))
        assert ids.dtype == np.int64
        assert_topk_match(ids, scores, jids, jscores)
        # unknown users: -1 / 0.0; dead slots past the catalog: -1 / 0.0
        assert (ids[~known] == -1).all() and (scores[~known] == 0).all()
        if "train" in kw:
            seen = set(zip(train.users.tolist(), train.items.tolist()))
            for u, row in zip(users, ids):
                assert not any((int(u), int(c)) in seen for c in row
                               if c >= 0)
    # over a (one-rank) mesh: the same lists; anything else is refused
    from large_scale_recommendation_tpu_torch.parallel import Partitioner

    ids, scores = tm.recommend(users, k=10, mesh=Partitioner(device="cpu"))
    assert_topk_match(ids, scores, *tm.recommend(users, k=10))
    with pytest.raises(TypeError, match="Partitioner"):
        tm.recommend(users, mesh=object())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_recommend_users_matches_jax(dtype):
    jm, tm, train, test = _models(dtype, seed=4)
    items = np.concatenate([test.items[:30], [10**7]])
    for kw in (dict(k=7), dict(k=5, train=train)):
        ids, scores = tm.recommend_users(items, **kw)
        jids, jscores = jm.recommend_users(items, **kw)
        assert_topk_match(ids, scores, jids, jscores)
        assert (ids[-1] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_ranking_quality_matches_jax(dtype):
    jm, tm, train, test = _models(dtype, seed=5)
    eu = np.concatenate([test.users, [10**6]])  # an unknown pair is dropped
    ei = np.concatenate([test.items, [3]])
    for kw in (dict(k=10), dict(k=5, train=train),
               dict(k=5, train=(train.users, train.items), chunk=33)):
        got = tm.ranking_quality(eu, ei, **kw)
        want = jm.ranking_quality(eu, ei, **kw)
        assert got["n"] == want["n"] == test.n
        assert abs(got["hr"] - want["hr"]) <= HR_TOL[dtype]
        assert abs(got["ndcg"] - want["ndcg"]) <= HR_TOL[dtype]


def test_tf32_is_off_inside_and_restored_after(monkeypatch):
    _, tm, _, _ = _models("float32")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    real = metrics._Scorer.__call__

    def spy(self, cu):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(self, cu)

    monkeypatch.setattr(metrics._Scorer, "__call__", spy)
    tm.recommend(tm.users.sorted_ids[:4], k=2)
    tm.ranking_quality(tm.users.sorted_ids[:4], tm.items.sorted_ids[:4])
    assert len(seen) == 2 and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32


def test_model_rank_and_dead_slot_contract():
    jm, tm, _, _ = _models("float32")
    assert tm.rank == jm.rank == 8
    assert metrics.DEAD_SLOT_OFFSET == jmetrics.DEAD_SLOT_OFFSET
    assert metrics.DEAD_SLOT_THRESHOLD == jmetrics.DEAD_SLOT_THRESHOLD
