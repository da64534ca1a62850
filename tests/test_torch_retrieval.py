"""The port's int8 two-stage retriever (``serving.retrieval``) against the
JAX package's, on the CPU, from the same seeded numpy inputs.

Bars:
- bit-equal: ``quantize_rows`` codes and scales; the flat stage-1
  candidates (values and rows: the int8 product is exact in f32, and JAX's
  op order after it is kept); the flat ``apply_delta`` against a rebuild
  and against JAX's; the clustered layout built from the same assignment;
- tie-aware, scores within 1e-5·max(1, |s|): ``TwoStageRetriever.topk``
  (flat, clustered on the JAX package's own layout through
  ``convert.quantized_catalog_from_jax``, and ``stage1_only``);
- the recall pins of ``tests/test_serving_retrieval.py`` (≥ 0.95 at
  overfetch 4).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.serving import retrieval as jret
from large_scale_recommendation_tpu.utils import metrics as jmetrics
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.serving import retrieval as tret
from large_scale_recommendation_tpu_torch.utils import metrics as tmetrics

CPU = torch.device("cpu")


def score_tol(s):
    return 1e-5 * np.maximum(1.0, np.abs(s))


def assert_topk_tie_aware(ids, scores, jids, jscores):
    """Scores within 1e-5·max(1,|s|) position by position; ids equal
    outside groups of scores that close; such groups equal as sets unless
    cut by the k-th place."""
    ids, scores = np.asarray(ids), np.asarray(scores)
    jids, jscores = np.asarray(jids), np.asarray(jscores)
    assert ids.shape == jids.shape
    finite = np.isfinite(jscores)
    np.testing.assert_array_equal(np.isfinite(scores), finite)
    assert (np.abs(scores[finite] - jscores[finite])
            <= score_tol(jscores[finite])).all()
    k = ids.shape[1]
    for r in range(ids.shape[0]):
        s = np.where(np.isfinite(jscores[r]), jscores[r], -3e38)
        close = np.abs(s[1:] - s[:-1]) <= 2 * score_tol(s[1:])
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


def catalog_V(n, rank, seed, structured=False, n_centers=16):
    rng = np.random.default_rng(seed)
    if structured:
        centers = rng.normal(size=(n_centers, rank)) * 2.0
        V = (centers[rng.integers(0, n_centers, n)]
             + 0.3 * rng.normal(size=(n, rank)))
    else:
        V = rng.normal(size=(n, rank))
    return V.astype(np.float32)


def exclusions(n_users, n_items, n_pairs, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n_pairs).astype(np.int64),
            rng.integers(0, n_items, n_pairs).astype(np.int64))


def both_excl(tu, ti, n_users, cu):
    """The exclusion triple of one chunk from both packages' builders
    (bit-equal), as (jax arrays, torch tensors)."""
    jx = jmetrics._exclusion_builder(tu, ti, n_users)(cu, len(cu))
    tx = tmetrics._exclusion_builder(tu, ti, n_users)(cu, len(cu))
    for a, b in zip(jx, tx):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    return (tuple(jnp.asarray(a) for a in jx),
            tuple(torch.from_numpy(b) for b in tx))


# -- quantization -----------------------------------------------------------


def test_quantize_rows_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(257, 16)).astype(np.float32)
    X[5] *= 1e4  # large-magnitude row: scale adapts per row
    X[9] = 0.0  # all-zero row: scale 1, exact round-trip
    X[11] = 0.5 * np.arange(16) - 3.5  # exact halves: round half to even
    jq, js = jret.quantize_rows(X)
    tq, ts = tret.quantize_rows(torch.from_numpy(X))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tret.dequantize_rows(tq, ts).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jret.dequantize_rows(jq, js)))
    assert (np.abs(deq - X) <= ts.numpy()[:, None] / 2 + 1e-6).all()
    np.testing.assert_array_equal(deq[9], 0.0)


def test_scale_is_rowmax_over_127():
    X = np.array([[1.0, -254.0], [0.0, 0.5]], np.float32)
    _, s = tret.quantize_rows(torch.from_numpy(X))
    np.testing.assert_allclose(s.numpy(), [2.0, 0.5 / 127], rtol=1e-6)


@pytest.mark.parametrize("rank", [8, 64, 1039])
def test_int8_product_equals_integer_reference(rank):
    """The f32 product of int8 values is exact below rank 1,040: every
    score equals the int64 product bit for bit, even at ±127 extremes."""
    rng = np.random.default_rng(rank)
    a = rng.integers(-127, 128, (33, rank)).astype(np.int8)
    b = rng.integers(-127, 128, (70, rank)).astype(np.int8)
    a[0], b[0] = 127, -127  # the largest magnitude a sum can reach
    got = tret.int8_scores(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64).T
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert got[0, 0] == -127 * 127 * rank


def test_int8_product_refuses_inexact_rank():
    q = torch.zeros((2, 1040), dtype=torch.int8)
    with pytest.raises(ValueError, match="1040"):
        tret.int8_scores(q, q)


# -- flat stage 1 -----------------------------------------------------------


@pytest.mark.parametrize("mask,train", [(False, False), (True, True),
                                        (True, False)])
@pytest.mark.parametrize("bucket", [8, 32])
def test_stage1_flat_candidates_bit_equal(mask, train, bucket):
    n_items, rank, n_users = 1024, 16, 40
    V = catalog_V(n_items, rank, seed=1)
    U = np.random.default_rng(2).normal(size=(n_users, rank)).astype(
        np.float32)
    item_mask = np.ones(n_items, bool)
    if mask:
        item_mask[::7] = False
    tu, ti = exclusions(n_users, n_items, 600, seed=4) if train else (None,
                                                                      None)
    cu = np.arange(bucket) % n_users
    jx, tx = both_excl(tu, ti, n_users, cu)
    jcat = jret.build_quantized_catalog(jnp.asarray(V), item_mask=item_mask)
    tcat = tret.build_quantized_catalog(torch.from_numpy(V),
                                        item_mask=item_mask)
    np.testing.assert_array_equal(tcat.q.numpy(), np.asarray(jcat.q))
    np.testing.assert_array_equal(tcat.item_w.numpy(),
                                  np.asarray(jcat.item_w))
    jqU, jus = jret.quantize_rows(U[cu])
    tqU, tus = tret.quantize_rows(torch.from_numpy(U[cu]))
    kc = 40
    jv, jr = jret._stage1_flat(jqU, jus, jcat.q, jcat.scale, jcat.item_w,
                               *jx, kc=kc)
    tv, tr = tret._stage1_flat(tqU, tus, tcat.q, tcat.scale, tcat.item_w,
                               *tx, kc=kc)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# -- clustered layout -------------------------------------------------------


def test_clustered_layout_bit_equal_given_the_same_assignment(monkeypatch):
    """Fed JAX's k-means assignment, the port's slab fill is JAX's bit for
    bit: codes, scales, weights, rows, routing centroids, positions."""
    V = catalog_V(1000, 8, seed=6, structured=True, n_centers=2)
    mask = np.ones(1000, bool)
    mask[3::50] = False
    cfg = jret.RetrievalConfig(n_clusters=8, kmeans_sample=1000,
                               slab_slack=1.0)
    fits, jax_kmeans = [], jret.kmeans_fit

    def jax_fit(*a, **kw):
        fits.append(jax_kmeans(*a, **kw))
        return fits[-1]

    monkeypatch.setattr(jret, "kmeans_fit", jax_fit)
    jcat = jret.build_quantized_catalog(jnp.asarray(V), item_mask=mask,
                                        config=cfg)
    monkeypatch.setattr(tret, "kmeans_fit", lambda *a, **kw: fits[0])
    tcfg = tret.RetrievalConfig(n_clusters=8, kmeans_sample=1000,
                                slab_slack=1.0)
    tcat = tret.build_quantized_catalog(torch.from_numpy(V), item_mask=mask,
                                        config=tcfg)
    assert jcat.stats["overflow_rows"] > 0  # the overflow block is used
    for f in tret.QuantizedCatalog._ARRAY_FIELDS:
        if getattr(jcat, f) is None:
            assert getattr(tcat, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(tcat, f).numpy(),
                                      np.asarray(getattr(jcat, f)), f)
    np.testing.assert_array_equal(tcat.pos_of_row, jcat.pos_of_row)
    for key in ("mode", "n_clusters", "slab_size", "overflow_rows",
                "max_cluster", "empty_clusters", "n_probe"):
        assert tcat.stats[key] == jcat.stats[key], key


def test_kmeans_assignment_agreement_with_jax():
    """Both k-means fits draw the same numpy samples; the assignment can
    differ only where two centroids are within rounding of each other.
    Measured on this seeded structured catalog: every one of the 4,096
    rows lands in the same cluster (the bar leaves room for near-ties)."""
    V = catalog_V(4096, 16, seed=2, structured=True)
    ja, jo, jr = jret.kmeans_fit(V, 32, sample=4096, seed=0, cap=256)
    ta, to, tr = tret.kmeans_fit(V, 32, sample=4096, seed=0, cap=256,
                                 device=CPU)
    agree = float((ja == ta).mean())
    assert agree >= 0.99, agree
    if agree == 1.0:
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tr, jr)


def test_capacity_assign_and_augment_bit_equal():
    rng = np.random.default_rng(5)
    choices = rng.integers(0, 6, (300, 3)).astype(np.int32)
    for a, b in zip(jret._capacity_assign(choices, 40, 6),
                    tret._capacity_assign(choices, 40, 6)):
        np.testing.assert_array_equal(a, b)
    V = catalog_V(50, 4, seed=1)
    np.testing.assert_array_equal(tret._augment(V), jret._augment(V))


def test_clustered_slabs_partition_every_row():
    V = catalog_V(1000, 8, seed=6)
    cat = tret.build_quantized_catalog(
        torch.from_numpy(V), config=tret.RetrievalConfig(
            n_clusters=8, kmeans_sample=1000, slab_slack=1.5))
    assert cat.clustered
    assert len(np.unique(cat.pos_of_row)) == 1000  # injective placement
    C, m, _ = cat.slab_q.shape
    rows = np.concatenate([cat.slab_rows.numpy().ravel(),
                           cat.ovf_rows.numpy()])
    assert sorted(rows[rows < 1000].tolist()) == list(range(1000))
    assert cat.stats["max_cluster"] <= cat.stats["capacity_cap"] == m
    assert cat.nbytes() == sum(
        t.numel() * t.element_size() for t in
        (getattr(cat, f) for f in cat._ARRAY_FIELDS) if t is not None)


# -- the retriever ----------------------------------------------------------


def _retrievers(V, cfg_kw, item_mask=None):
    jr = jret.TwoStageRetriever(jnp.asarray(V), item_mask=item_mask,
                                config=jret.RetrievalConfig(**cfg_kw))
    tr = tret.TwoStageRetriever(torch.from_numpy(V), item_mask=item_mask,
                                config=tret.RetrievalConfig(**cfg_kw))
    return jr, tr


@pytest.mark.parametrize("stage1_only", [False, True])
@pytest.mark.parametrize("k", [10, 5])
def test_topk_flat_matches_jax(stage1_only, k):
    n_items, rank, n_users = 2048, 16, 64
    V = catalog_V(n_items, rank, seed=1)
    U = np.random.default_rng(7).normal(size=(n_users, rank)).astype(
        np.float32)
    mask = np.ones(n_items, bool)
    mask[5::11] = False
    jr, tr = _retrievers(V, dict(overfetch=4), item_mask=mask)
    tu, ti = exclusions(n_users, n_items, 2000, seed=8)
    cu = np.arange(32)
    jx, tx = both_excl(tu, ti, n_users, cu)
    jv, jrows = jr.topk(jnp.asarray(U[cu]), jx, k=k, stage1_only=stage1_only)
    tv, trows = tr.topk(torch.from_numpy(U[cu]), tx, k=k,
                        stage1_only=stage1_only)
    if stage1_only:  # approximate scores pass through: bit-equal
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert_topk_tie_aware(trows.numpy(), tv.numpy(), jrows, jv)
    assert tr.buckets_seen == {("flat", 32, 4 * k)}


@pytest.mark.parametrize("stage1_only", [False, True])
def test_topk_clustered_on_jax_layout_matches_jax(stage1_only):
    """The port's clustered stages run on the JAX package's own layout
    (``quantized_catalog_from_jax``), so only the stages differ."""
    n_items, rank, n_users = 4096, 16, 64
    V = catalog_V(n_items, rank, seed=2, structured=True)
    U = np.random.default_rng(9).normal(size=(n_users, rank)).astype(
        np.float32)
    kw = dict(overfetch=4, n_clusters=32, n_probe=12, kmeans_sample=4096)
    jr = jret.TwoStageRetriever(jnp.asarray(V),
                                config=jret.RetrievalConfig(**kw))
    tr = tret.TwoStageRetriever(torch.from_numpy(V),
                                config=tret.RetrievalConfig(overfetch=4))
    tr.config = tret.RetrievalConfig(**kw)
    tr.catalog = convert.quantized_catalog_from_jax(jr.catalog, device="cpu")
    assert tr.catalog.clustered and tr.candidate_count(10) == \
        jr.candidate_count(10)
    tu, ti = exclusions(n_users, n_items, 3000, seed=10)
    cu = np.arange(64)
    jx, tx = both_excl(tu, ti, n_users, cu)
    jv, jrows = jr.topk(jnp.asarray(U[cu]), jx, k=10,
                        stage1_only=stage1_only)
    tv, trows = tr.topk(torch.from_numpy(U[cu]), tx, k=10,
                        stage1_only=stage1_only)
    assert_topk_tie_aware(trows.numpy(), tv.numpy(), jrows, jv)
    assert tr.buckets_seen == {("clustered", 64, 40)}


def test_candidate_count_matches_jax():
    V = catalog_V(300, 8, seed=3)
    jr, tr = _retrievers(V, dict(overfetch=4))
    for k in (1, 10, 80, 400):
        assert tr.candidate_count(k) == jr.candidate_count(k)


def test_topk_refuses_uint32_key_overflow():
    """The JAX package packs (query, item) into uint32 keys; the port
    keeps its bucket·(n+1) < 2³² contract."""
    tr = tret.TwoStageRetriever(torch.from_numpy(catalog_V(64, 4, seed=1)))
    tr.catalog = dataclasses.replace(tr.catalog, n_rows=2**26)
    excl = tuple(torch.from_numpy(a) for a in
                 tmetrics._exclusion_builder(None, None, 1)(np.zeros(64), 64))
    with pytest.raises(ValueError, match="uint32"):
        tr.topk(torch.zeros((64, 4)), excl, k=5)


def test_rank_sharded_partitioner_is_not_ported():
    """Rank-sharded retrieval is ported now (the name is kept from when it
    raised; tests/test_torch_rank_sharding.py runs it on 4 gloo ranks): a
    one-rank partitioner keeps the one-device layout, and a JAX catalog
    that is rank-sharded converts whole, bit-equal to the JAX package's
    replicated catalog of the same table (flat and clustered)."""
    from large_scale_recommendation_tpu.parallel.partitioner import (
        Partitioner as JPartitioner,
    )
    from large_scale_recommendation_tpu_torch.parallel.partitioner import (
        Partitioner,
    )

    V = torch.from_numpy(catalog_V(64, 4, seed=1))
    one = Partitioner(device="cpu")
    a = tret.build_quantized_catalog(V, partitioner=one)
    b = tret.build_quantized_catalog(V)
    assert a.partitioner is None
    assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    ret = tret.TwoStageRetriever(V, partitioner=one)
    assert ret.partitioner is None and torch.equal(ret.V, V)

    jp = JPartitioner(num_devices=8, model_parallel=2)
    for nc in (None, 4):
        cfg = jret.RetrievalConfig(n_clusters=nc, kmeans_iters=2)
        shd = jret.build_quantized_catalog(V.numpy(), config=cfg,
                                           partitioner=jp)
        rep = jret.build_quantized_catalog(V.numpy(), config=cfg)
        assert shd.stats["rank_sharded"] == 2
        got = convert.quantized_catalog_from_jax(shd, device="cpu")
        want = convert.quantized_catalog_from_jax(rep, device="cpu")
        assert got.partitioner is None and "rank_sharded" not in got.stats
        for f in tret.QuantizedCatalog._ARRAY_FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x, y), f


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(-1, 20, (30, 10))
    e = rng.integers(-1, 20, (30, 10))
    e[3] = -1  # an empty exact list counts 1.0
    assert tret.recall_at_k(a, e) == jret.recall_at_k(a, e)
    assert tret.recall_at_k(a[0], e[0]) == jret.recall_at_k(a[0], e[0])


# -- deltas -----------------------------------------------------------------


def _patched(V1, rows, seed=7):
    rng = np.random.default_rng(seed)
    V2 = V1.copy()
    V2[rows] = rng.normal(size=(len(rows), V1.shape[1])).astype(np.float32)
    return V2


def test_flat_delta_bit_equals_rebuild_and_jax():
    V1 = catalog_V(64, 8, seed=9)
    rows = np.array([1, 7, 63])
    V2 = _patched(V1, rows)
    cat1 = tret.build_quantized_catalog(torch.from_numpy(V1))
    rebuilt = tret.build_quantized_catalog(torch.from_numpy(V2))
    delta = cat1.apply_delta(rows, torch.from_numpy(V2[rows]),
                             version=rebuilt.version)
    jdelta = jret.build_quantized_catalog(jnp.asarray(V1)).apply_delta(
        rows, jnp.asarray(V2[rows]), version=0)
    for f in ("q", "scale"):
        np.testing.assert_array_equal(getattr(delta, f).numpy(),
                                      getattr(rebuilt, f).numpy())
        np.testing.assert_array_equal(getattr(delta, f).numpy(),
                                      np.asarray(getattr(jdelta, f)))
    assert delta.version == rebuilt.version
    # out of place: the first catalog is untouched
    np.testing.assert_array_equal(
        cat1.q.numpy(), tret.quantize_rows(torch.from_numpy(V1))[0].numpy())


def test_clustered_delta_requantizes_dirty_rows():
    V1 = catalog_V(500, 8, seed=10, structured=True, n_centers=2)
    rows = np.arange(0, 500, 7)
    V2 = _patched(V1, rows)
    cat = tret.build_quantized_catalog(
        torch.from_numpy(V1), config=tret.RetrievalConfig(
            n_clusters=16, kmeans_sample=500, slab_slack=1.0))
    assert cat.stats["overflow_rows"] > 0
    delta = cat.apply_delta(rows, V2[rows], version=999)  # host values
    q2, s2 = tret.quantize_rows(torch.from_numpy(V2))
    C, m, r = delta.slab_q.shape
    flat_q = np.concatenate([delta.slab_q.numpy().reshape(-1, r),
                             delta.ovf_q.numpy()])
    flat_s = np.concatenate([delta.slab_scale.numpy().ravel(),
                             delta.ovf_scale.numpy()])
    np.testing.assert_array_equal(flat_q[cat.pos_of_row], q2.numpy())
    np.testing.assert_array_equal(flat_s[cat.pos_of_row], s2.numpy())
    assert delta.version == 999
    assert delta.apply_delta([], None, version=5).version == 5


def test_retriever_delta_equals_rebuilt_retriever():
    V1 = catalog_V(256, 8, seed=11)
    rows = np.array([0, 17, 200, 255])
    V2 = _patched(V1, rows)
    ret = tret.TwoStageRetriever(torch.from_numpy(V1))
    held = ret.V
    ret.apply_delta(rows, V2[rows], version=42)
    fresh = tret.TwoStageRetriever(torch.from_numpy(V2))
    np.testing.assert_array_equal(ret.V.numpy(), V2)
    np.testing.assert_array_equal(held.numpy(), V1)  # never in place
    np.testing.assert_array_equal(ret.catalog.q.numpy(),
                                  fresh.catalog.q.numpy())
    assert ret.version == 42
    ret.apply_delta([], None, version=43)
    assert ret.version == 43


def test_retriever_owns_its_table():
    V = torch.from_numpy(catalog_V(64, 8, seed=12))
    ret = tret.TwoStageRetriever(V)
    before = ret.V.clone()
    V.add_(1.0)
    assert torch.equal(ret.V, before)


# -- recall pins (tests/test_serving_retrieval.py:76,106) -------------------


def _model(num_users, num_items, rank, seed, structured=False):
    from large_scale_recommendation_tpu_torch.data.blocking import flat_index
    from large_scale_recommendation_tpu_torch.models.mf import MFModel

    rng = np.random.default_rng(seed)
    if structured:
        centers = rng.normal(size=(16, rank)) * 2.0
        V = (centers[rng.integers(0, 16, num_items)]
             + 0.3 * rng.normal(size=(num_items, rank)))
    else:
        V = rng.normal(size=(num_items, rank))
    U = rng.normal(size=(num_users, rank)).astype(np.float32)
    return MFModel(U=torch.from_numpy(U),
                   V=torch.from_numpy(V.astype(np.float32)),
                   users=flat_index(np.arange(num_users, dtype=np.int64)),
                   items=flat_index(np.arange(num_items, dtype=np.int64)))


def test_flat_recall_pin_at_overfetch_4():
    from large_scale_recommendation_tpu_torch.serving import ServingEngine

    model = _model(300, 2048, 16, seed=1)
    exact = ServingEngine(model, k=10)
    fast = ServingEngine(model, k=10,
                         retrieval=tret.RetrievalConfig(overfetch=4))
    uids = np.arange(300)
    ie, se = exact.recommend(uids)
    ia, sa = fast.recommend(uids)
    assert tret.recall_at_k(ia, ie) >= 0.95
    # stage 2 rescored exactly: a returned (id, score) is the exact one
    exact_scores = {(q, int(i)): se[q, j] for q in range(len(uids))
                    for j, i in enumerate(ie[q])}
    checked = 0
    for q in range(len(uids)):
        for j, i in enumerate(ia[q]):
            if (q, int(i)) in exact_scores:
                np.testing.assert_allclose(sa[q, j], exact_scores[q, int(i)],
                                           rtol=1e-5, atol=1e-5)
                checked += 1
    assert checked > 1000


def test_clustered_recall_pin_on_structured_catalog():
    from large_scale_recommendation_tpu_torch.serving import ServingEngine

    model = _model(256, 4096, 16, seed=2, structured=True)
    exact = ServingEngine(model, k=10)
    fast = ServingEngine(model, k=10, retrieval=tret.RetrievalConfig(
        overfetch=4, n_clusters=32, n_probe=12, kmeans_sample=4096))
    uids = np.arange(256)
    ie, _ = exact.recommend(uids)
    ia, _ = fast.recommend(uids)
    assert tret.recall_at_k(ia, ie) >= 0.95
