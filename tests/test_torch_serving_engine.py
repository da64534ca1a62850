"""The port's serving engine (``serving.engine``, ``parallel.serving``,
``ops.topk``) against the JAX package's on the CPU, from the same seeded
numpy inputs.

The JAX engine runs on a one-device mesh (``make_block_mesh(1)``), the
port's engine on CPU tensors. Bars: the exact engine's lists tie-aware,
scores within 1e-5·max(1, |s|) (the two matmuls sum in other orders);
the flat two-stage engine the same (its stage 1 is bit-equal, stage 2's
rescore at that bar). The flush's one id translation (one lookup, item
ids mapped on the device, answers as views) is held bit-equal to the
per-request path it replaced, kept here as the reference. Then the engine
contracts: bucket validation,
``serve`` alignment past pre-queued submits, the bounded shape family,
deferred deltas equal to eager ones, vocab growth, the version moving on
``refresh``, on ``apply_delta`` and after in-place modification, the part
not ported (``mesh=``) raising, and ``user_store=`` serving a tiered
store's rows.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch.profiler import ProfilerActivity, profile

from large_scale_recommendation_tpu.data.blocking import (
    flat_index as jflat_index,
)
from large_scale_recommendation_tpu.models.mf import MFModel as JMFModel
from large_scale_recommendation_tpu.parallel import serving as jps
from large_scale_recommendation_tpu.parallel.mesh import make_block_mesh
from large_scale_recommendation_tpu.serving import RetrievalConfig as JCfg
from large_scale_recommendation_tpu.serving.engine import (
    ServingEngine as JEngine,
)
from large_scale_recommendation_tpu.utils import metrics as jmetrics
from large_scale_recommendation_tpu.utils import shapes as jshapes
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data.blocking import flat_index
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.ops import topk
from large_scale_recommendation_tpu_torch.parallel import serving as tps
from large_scale_recommendation_tpu_torch.store import TieredFactorStore
from large_scale_recommendation_tpu_torch.serving import (
    RecResult,
    RetrievalConfig,
    ServingEngine,
)
from large_scale_recommendation_tpu_torch.utils import metrics as tmetrics
from large_scale_recommendation_tpu_torch.utils import shapes as tshapes
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)
from test_torch_retrieval import assert_topk_tie_aware


def models(num_users=60, num_items=256, rank=8, seed=0, padded=True):
    """The same tables as a JAX and a port ``MFModel``; ``padded`` gives
    the id maps padding rows (-1 ids) and sparse external ids, as a
    blocked model has."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(num_users, rank)).astype(np.float32)
    V = rng.normal(size=(num_items, rank)).astype(np.float32)
    uids = np.arange(num_users, dtype=np.int64) * 3 + 1
    iids = np.arange(num_items, dtype=np.int64) * 5 + 2
    if padded:
        uids[-2:] = -1
        iids[::9] = -1
    jm = JMFModel(U=jnp.asarray(U), V=jnp.asarray(V),
                  users=jflat_index(uids), items=jflat_index(iids))
    tm = convert.model_from_jax(U, V, jm.users, jm.items, device="cpu")
    return jm, tm


def train_pairs(jm, n=900, seed=1):
    rng = np.random.default_rng(seed)
    u = jm.users.ids[jm.users.ids >= 0]
    i = jm.items.ids[jm.items.ids >= 0]
    return (rng.choice(u, n).astype(np.int64),
            rng.choice(i, n).astype(np.int64))


def real_users(tm, n=None):
    ids = tm.users.ids[tm.users.ids >= 0]
    return ids if n is None else ids[:n]


def assert_results_match(res, jres):
    ids, scores = res[0], res[1]
    jids, jscores = np.asarray(jres[0]), np.asarray(jres[1])
    assert ids.dtype == np.int64 and scores.dtype == np.float32
    # dead slots: -1 / 0.0 in both
    np.testing.assert_array_equal(ids < 0, jids < 0)
    assert_topk_tie_aware(np.where(ids < 0, -1, ids), scores,
                          np.where(jids < 0, -1, jids), jscores)


# -- parity with the JAX engine --------------------------------------------


@pytest.mark.parametrize("k", [6, 300])
@pytest.mark.parametrize("train", [False, True])
def test_exact_engine_matches_jax(k, train):
    """Train exclusions, unknown users (-1/0.0 rows, mask False) and k
    above the catalog (slots past it -1/0.0)."""
    jm, tm = models()
    tr = train_pairs(jm) if train else None
    j = JEngine(jm, k=k, mesh=make_block_mesh(1), train=tr, max_batch=32)
    t = ServingEngine(tm, k=k, train=tr, max_batch=32)
    uids = np.concatenate([real_users(tm, 45), [999_999, -5]])
    res = t.recommend(uids, return_mask=True)
    jres = j.recommend(uids, return_mask=True)
    assert_results_match(res, jres)
    np.testing.assert_array_equal(res[2], np.asarray(jres[2]))
    assert not res[2][-2:].any() and (res[0][-2:] == -1).all()
    assert (res[1][-2:] == 0.0).all()
    if k > tm.V.shape[0]:
        assert (res[0][:, tm.V.shape[0]:] == -1).all()
    assert t.stats["microbatches"] == j.stats["microbatches"]
    assert t.stats["buckets"] == j.stats["buckets"]


@pytest.mark.parametrize("stage1_only", [False, True])
def test_two_stage_engine_matches_jax(stage1_only):
    jm, tm = models(num_items=1024, seed=2)
    tr = train_pairs(jm, seed=3)
    j = JEngine(jm, k=10, mesh=make_block_mesh(1), train=tr,
                retrieval=JCfg(overfetch=4))
    t = ServingEngine(tm, k=10, train=tr,
                      retrieval=RetrievalConfig(overfetch=4))
    uids = np.concatenate([real_users(tm), [123_456]])
    rows = tm.users.rows_for(uids)[0][:-1]
    jx = jmetrics._exclusion_builder(*jm._train_rows(tr), 60)
    tx = topk.exclusion_builder(*tm._train_rows(tr), 60)
    if stage1_only:  # the degraded point, straight through the retriever
        cu = np.concatenate([rows, np.zeros(64 - len(rows), np.int64)])
        jv, jr = j.retriever.topk(jm.U[cu], jx(cu, len(rows)), k=10,
                                  stage1_only=True)
        tv, trr = t.retriever.topk(
            tm.U[torch.from_numpy(cu)], tuple(
                torch.from_numpy(a) for a in tx(cu, len(rows))), k=10,
            stage1_only=True)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(trr.numpy(), np.asarray(jr))
        return
    assert_results_match(t.recommend(uids), j.recommend(uids))


def test_bf16_engine_matches_jax_bf16_engine():
    """bf16 catalogs score as f32 sums of the bf16 rows in both packages
    (the JAX product's f32 accumulation), so the two bf16 engines agree at
    the f32 bar."""
    jm, tm = models(seed=4)
    j = JEngine(jm, k=6, mesh=make_block_mesh(1), dtype="bfloat16")
    t = ServingEngine(tm, k=6, dtype="bfloat16")
    assert t._catalog.dtype == "bfloat16"
    assert t._catalog.V_sh.dtype == torch.bfloat16
    uids = real_users(tm)
    assert_results_match(t.recommend(uids), j.recommend(uids))


def test_bf16_catalog_parity_with_f32():
    """tests/test_serving_engine.py's bound on its fitted model (ALS, 60
    users × 41 items, rank 6): identical top-K id sets, scores within 2e-2
    of the f32 engine's."""
    from large_scale_recommendation_tpu_torch.core.generators import (
        SyntheticMFGenerator,
    )
    from large_scale_recommendation_tpu_torch.models.als import (
        ALS,
        ALSConfig,
    )

    gen = SyntheticMFGenerator(num_users=60, num_items=41, rank=4,
                               noise=0.05, seed=6)
    train = gen.generate(6000)
    tm = ALS(ALSConfig(num_factors=6, lambda_=0.05, iterations=4),
             device="cpu").fit(train)
    f32 = ServingEngine(tm, k=6, train=train)
    bf16 = ServingEngine(tm, k=6, train=train, dtype="bfloat16")
    uids = np.arange(60)
    ids32, s32 = f32.recommend(uids)
    ids16, s16 = bf16.recommend(uids)
    for row32, row16 in zip(ids32, ids16):
        assert set(row32.tolist()) == set(row16.tolist())
    np.testing.assert_allclose(s16, s32, rtol=2e-2, atol=2e-2)


def _swapped(tm):
    """``tm`` with the roles of users and items swapped: its engine serves
    ``tm.recommend_users``' lists."""
    return dataclasses.replace(tm, U=tm.V, V=tm.U, users=tm.items,
                               items=tm.users)


MODEL_CASES = {
    "recommend": dict(padded=False),
    "recommend_users": dict(padded=False, users=True),
    "unknown_ids": dict(padded=False, unknown=True),
    "k_above_catalog": dict(padded=False, k=300),
    # -1 ids on padding rows of both tables: masked item rows
    "masked_rows": dict(unknown=True),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_engine_matches_model_recommend(case):
    """``MFModel.recommend`` / ``recommend_users`` and ``ServingEngine``
    give bit-equal ids, scores and masks: both score through
    ``ops.topk`` and map rows to ids on the device."""
    c = MODEL_CASES[case]
    jm, tm = models(seed=6, padded=c.get("padded", True))
    tu, ti = train_pairs(jm)
    k = c.get("k", 6)
    if c.get("users"):
        eng = ServingEngine(_swapped(tm), k=k, train=(ti, tu))
        queries = tm.items.ids[tm.items.ids >= 0][:40]
        ask = tm.recommend_users
    else:
        eng = ServingEngine(tm, k=k, train=Ratings.from_arrays(
            tu, ti, np.ones(len(tu), np.float32)))
        queries = real_users(tm, 20)
        ask = tm.recommend
    if c.get("unknown"):
        queries = np.concatenate([queries[:7], [99_999], queries[7:], [-5]])
    i1, s1, m1 = eng.recommend(queries, return_mask=True)
    i0, s0, m0 = ask(queries, k=k, train=(tu, ti), return_mask=True)
    np.testing.assert_array_equal(m1, m0)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(s1, s0)
    assert m0.all() != c.get("unknown", False)
    if k > tm.V.shape[0]:
        assert (i0[:, tm.V.shape[0]:] == -1).all()


def test_exclusion_builder_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    tu = rng.integers(0, 50, 700)
    ti = rng.integers(0, 90, 700)
    for cu, c in ((np.arange(16), 16), (rng.integers(0, 50, 32), 20),
                  (np.array([49, 49, 0]), 3)):
        for a, b in zip(jmetrics._exclusion_builder(tu, ti, 50)(cu, c),
                        topk.exclusion_builder(tu, ti, 50)(cu, c)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(jmetrics._exclusion_builder(None, None, 50)(cu, 3),
                    topk.exclusion_builder(None, None, 50)(cu, 3)):
        np.testing.assert_array_equal(a, b)


def test_pow2_buckets_and_meter_match_jax():
    for floor, cap in ((8, 1024), (4, 64), (5, 128), (1, 1), (16, 8)):
        assert tshapes.pow2_buckets(floor, cap) == \
            jshapes.pow2_buckets(floor, cap)
    m = tmetrics.ThroughputMeter()
    assert m.rate == 0.0
    m.record(300, 0.5)
    m.record(100, 0.5)
    assert m.rate == 400.0 and m.total_elements == 400


# -- the scoring step and the pipeline --------------------------------------


def test_topk_step_matches_jax_step():
    """``topk_step`` against ``_mesh_topk_step`` on one device: masked
    rows, exclusions, k above the real candidate supply."""
    rng = np.random.default_rng(8)
    V = rng.normal(size=(50, 8)).astype(np.float32)
    U = rng.normal(size=(16, 8)).astype(np.float32)
    mask = np.ones(50, bool)
    mask[::4] = False
    excl = topk.exclusion_builder(rng.integers(0, 16, 80),
                                       rng.integers(0, 50, 80), 16)(
        np.arange(16), 16)
    jcat = jps.shard_catalog(jnp.asarray(V), make_block_mesh(1),
                             item_mask=mask)
    step = jps._mesh_topk_step(jcat.mesh, 10, 10, jcat.rows_per_shard)
    jv, jr = step(jnp.asarray(U), jcat.V_sh, jcat.w_sh,
                  *(jnp.asarray(a) for a in excl))
    tcat = tps.shard_catalog(torch.from_numpy(V), item_mask=mask)
    np.testing.assert_array_equal(tcat.w_sh.numpy(), np.asarray(jcat.w_sh))
    tv, tr = topk.topk_step(torch.from_numpy(U), tcat.V_sh, tcat.w_sh,
                           *(torch.from_numpy(a) for a in excl), k_out=10)
    assert_topk_tie_aware(tr.numpy(), tv.numpy(), jr, jv)


def test_run_pipelined_topk_clamps_pads_and_keeps_order():
    """Results land one chunk behind the dispatch, in row order; rows past
    the catalog (slab pads) come back as row 0 / -inf."""
    calls = []

    def score_chunk(cu, c):
        calls.append((len(cu), c))
        rows = torch.from_numpy(np.stack([cu, cu + 100], 1))
        return rows.float(), rows

    rows, scores = topk.run_pipelined_topk(
        np.arange(20), k=3, k_out=2, n_rows=110, slice_size=8,
        bucket_fn=lambda c: 8, score_chunk=score_chunk)
    assert calls == [(8, 8), (8, 8), (8, 4)]
    np.testing.assert_array_equal(rows[:10, 0], np.arange(10))
    assert (rows[:10, 1] == np.arange(100, 110)).all()
    assert (rows[10:, 1] == 0).all() and np.isneginf(scores[10:, 1]).all()
    assert np.isneginf(scores[:, 2]).all()  # past k_out
    empty = topk.run_pipelined_topk(np.zeros(0, np.int64), k=3, k_out=2,
                                   n_rows=5, slice_size=8,
                                   bucket_fn=lambda c: 8,
                                   score_chunk=score_chunk)
    assert empty[0].shape == (0, 3)


# -- one id translation per flush -------------------------------------------


def assemble_topk(n, k, known, top_rows, top_scores, ids_of_row,
                  return_mask):
    """Row-space top-K → external ids on the host, the rule the device
    route (``ops.topk.ids_of_top``) replaced, kept as its reference:
    unknown queries get -1 / 0.0 rows; slots below
    ``DEAD_SLOT_THRESHOLD`` (excluded or masked rows) become -1 / 0.0
    too."""
    ids = np.full((n, k), -1, np.int64)
    scores = np.zeros((n, k), np.float32)
    real = top_scores > topk.DEAD_SLOT_THRESHOLD
    ids[known] = np.where(real, ids_of_row[top_rows], -1)
    scores[known] = np.where(real, top_scores, 0.0)
    if return_mask:
        return ids, scores, known
    return ids, scores


def per_request_answers(eng, requests, return_mask=False):
    """The engine's answers as its per-request path assembled them (kept
    as the reference): a lookup per request, the known rows scored
    through ``run_pipelined_topk``'s row-space route (pad rows clamped on
    the host), ``assemble_topk`` per request over the host id map. Also
    returns whether a pad row (≥ the catalog's rows) surfaced."""
    known, rows = [], []
    for ids in requests:
        r, m = eng.model.users.rows_for(ids)
        known.append(m > 0)
        rows.append(r[m > 0])
    ret, surfaced = eng.retriever, []
    if ret is not None:
        k_out, n_rows = min(eng.k, ret.candidate_count(eng.k)), ret.n_rows
        size = min(eng.max_batch, ret.config.max_bucket)
    else:
        k_out, n_rows, size = eng._k_out, eng._catalog.n_rows, eng.max_batch

    def score_chunk(cu, c):
        excl = tuple(torch.from_numpy(a) for a in eng._build_excl(cu, c))
        U_chunk = eng._U.index_select(0, torch.from_numpy(
            cu.astype(np.int64)))
        if ret is not None:
            v, r = ret.topk(U_chunk, excl, k=eng.k, rows=c)
        else:
            cat = eng._catalog
            v, r = topk.topk_step(U_chunk, cat.V_sh, cat.w_sh, *excl,
                                 k_out=k_out)
        surfaced.append(bool((r[:c] >= n_rows).any()))
        return v, r

    top_rows, top_scores = topk.run_pipelined_topk(
        np.concatenate(rows), k=eng.k, k_out=k_out, n_rows=n_rows,
        slice_size=size,
        bucket_fn=lambda c: min(tshapes.pow2_pad(c, eng.min_bucket), size),
        score_chunk=score_chunk)
    ids_of_row = np.asarray(eng.model.items.ids)
    out, b0 = [], 0
    for kn in known:
        b1 = b0 + int(kn.sum())
        out.append(assemble_topk(len(kn), eng.k, kn, top_rows[b0:b1],
                                 top_scores[b0:b1], ids_of_row,
                                 return_mask))
        b0 = b1
    return out, any(surfaced)


def _stage1_only(retriever):
    """Every ``retriever.topk`` call at the degraded point."""
    topk = retriever.topk
    retriever.topk = lambda *a, **kw: topk(*a, **{**kw, "stage1_only": True})


def _other_item_index(tm, seed):
    """``tm`` with new item factors under a permuted item index (ids move
    to other rows, padding rows too)."""
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        tm, V=torch.from_numpy(rng.normal(size=tuple(tm.V.shape)).astype(
            np.float32)),
        items=flat_index(rng.permutation(tm.items.ids)))


FLUSH_CASES = {
    "exact": dict(),
    "exact_mask": dict(return_mask=True),
    # k above the catalog's 256 rows, 29 of them masked: dead slots
    "exact_dead_slots": dict(k=300, return_mask=True),
    "two_stage": dict(retrieval=RetrievalConfig(overfetch=4),
                      num_items=1024),
    "stage1_only": dict(retrieval=RetrievalConfig(overfetch=4),
                        num_items=1024, stage1_only=True),
    # clusters of ~32 items, one probed, k = 48: slab pad rows surface
    "clustered_pads": dict(retrieval=RetrievalConfig(
        n_clusters=8, n_probe=1, overfetch=1, kmeans_sample=256), k=48,
        pads=True),
    "refresh": dict(refresh=True),
    "two_stage_refresh": dict(retrieval=RetrievalConfig(overfetch=4),
                              refresh=True, return_mask=True),
}


@pytest.mark.parametrize("case", list(FLUSH_CASES))
def test_flush_answers_equal_the_per_request_path(case):
    """The flush's one lookup, device id map and views give bit-equal
    ids, scores and masks to the per-request path: known and unknown
    users mixed, an empty request and an all-unknown one, several
    micro-batches a flush; dead slots, surfaced slab pads, the degraded
    point; and after ``refresh()`` onto another item index, the new map."""
    c = FLUSH_CASES[case]
    jm, tm = models(num_items=c.get("num_items", 256), seed=30)
    tr = train_pairs(jm, seed=31)
    eng = ServingEngine(tm, k=c.get("k", 6), train=tr, max_batch=16,
                        retrieval=c.get("retrieval"))
    users = real_users(tm)
    requests = [users[:5], np.array([999_999, users[5], -5]),
                np.zeros(0, np.int64), users[6:7], np.array([424_242]),
                users[7:40], users[40:], np.array([users[3], 31_337])]
    if c.get("refresh"):
        eng.serve(requests)
        eng.refresh(_other_item_index(tm, 32))
    if c.get("stage1_only"):
        _stage1_only(eng.retriever)
    rm = c.get("return_mask", False)
    for r in requests:
        eng.submit(r)
    got = eng.flush(return_mask=rm)  # one flush, as the reference
    want, surfaced = per_request_answers(eng, requests, rm)
    assert surfaced == c.get("pads", False)
    assert len(got) == len(want) == len(requests)
    for g, w in zip(got, want):
        assert len(g) == len(w) == (3 if rm else 2)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    if c.get("k", 6) > 256 or c.get("pads"):
        assert (got[0][0] == -1).any()


def test_assemble_counts_views_and_answers_are_disjoint_views():
    """``serving/assemble`` counts ``views == requests`` when every user
    is known, and each request with an unknown user as a non-view (it gets
    its own arrays); adjacent answers are disjoint views of the flush's
    pair, so writing into one leaves its neighbour as it was."""
    _, tm = models(seed=33)
    eng = ServingEngine(tm, k=5, max_batch=16)
    users = real_users(tm)
    known = [users[:3], users[3:4], np.zeros(0, np.int64), users[4:9]]
    mixed = [users[:2], np.array([999_999]), users[2:4],
             np.array([users[5], -7])]
    counts = []
    try:
        for reqs in (known, mixed):
            ptr.reset_span_totals()
            with profile(activities=[ProfilerActivity.CPU]):
                res = eng.serve(reqs)  # under 16 rows: one flush
            counts.append(ptr.span_totals()["serving/assemble"]["args"])
            if reqs is known:
                kres = res
    finally:
        ptr.reset_span_totals()
    assert counts[0]["views"] == counts[0]["requests"] == 4
    assert counts[1]["requests"] == 4 and counts[1]["views"] == 2
    assert res[1][0].base is None and res[3][0].base is None
    a, b = kres[0], kres[1]
    assert a[0].base is b[0].base is not None
    assert a[1].base is b[1].base is not None
    before = b[0].copy(), b[1].copy()
    a[0][:] = -99
    a[1][:] = 7.0
    np.testing.assert_array_equal(b[0], before[0])
    np.testing.assert_array_equal(b[1], before[1])


def test_run_pipelined_topk_id_route_equals_host_assembly():
    """With ``ids_of_row`` the chunks' rows become ids on the device: the
    result equals the row-space route's clamp plus ``assemble_topk``,
    bit for bit — pad rows (finite scores here) and dead slots -1 / 0.0,
    slots past ``k_out`` too — and the row-space route is unchanged."""
    def score_chunk(cu, c):
        rows = torch.from_numpy(np.stack([cu, cu + 100, cu * 0], 1))
        vals = rows.float()
        vals[:, 2] = topk.DEAD_SLOT_OFFSET
        return vals, rows

    ids_of_row = np.arange(110, dtype=np.int64) * 7 + 3
    kw = dict(k=4, k_out=3, n_rows=110, slice_size=8,
              bucket_fn=lambda c: 8, score_chunk=score_chunk)
    rows, scores = topk.run_pipelined_topk(np.arange(20), **kw)
    want = assemble_topk(20, 4, np.ones(20, bool), rows, scores,
                         ids_of_row, False)
    got = topk.run_pipelined_topk(np.arange(20), **kw,
                                 ids_of_row=torch.from_numpy(ids_of_row))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (got[0][10:, 1] == -1).all() and (got[1][10:, 1] == 0.0).all()
    assert (got[0][:10, 1] == ids_of_row[100:110]).all()
    assert (got[0][:, 2:] == -1).all()


def test_sharded_catalog_delta_bit_equals_rebuild():
    rng = np.random.default_rng(8)
    V1 = rng.normal(size=(100, 8)).astype(np.float32)
    rows = np.array([0, 3, 50, 99])
    V2 = V1.copy()
    V2[rows] = rng.normal(size=(4, 8)).astype(np.float32)
    mask = np.ones(100, bool)
    mask[17] = False
    for dtype in (None, "bfloat16"):
        cat1 = tps.shard_catalog(torch.from_numpy(V1), item_mask=mask,
                                 dtype=dtype)
        rebuilt = tps.shard_catalog(torch.from_numpy(V2), item_mask=mask,
                                    dtype=dtype)
        delta = cat1.apply_delta(rows, V2[rows])
        assert torch.equal(delta.V_sh, rebuilt.V_sh)
        assert torch.equal(delta.w_sh, rebuilt.w_sh)
        assert delta.version != cat1.version
        assert torch.equal(cat1.V_sh, tps.shard_catalog(
            torch.from_numpy(V1), dtype=dtype).V_sh)  # out of place
        assert cat1.apply_delta([], None, version=7).version == 7


def test_catalog_version_tracks_object_and_in_place_writes():
    V = torch.zeros(4, 2)
    v0 = tps.catalog_version(V)
    assert tps.catalog_version(V) == v0  # stable while unmodified
    V.add_(1.0)
    v1 = tps.catalog_version(V)
    assert v1 != v0 and tps.catalog_version(V) == v1
    W = V.clone()
    assert tps.catalog_version(W) not in (v0, v1)
    arr = np.zeros(3)
    assert tps.catalog_version(arr) == tps.catalog_version(arr)


def test_shard_catalog_owns_its_table_and_checks_dtype():
    V = torch.ones(5, 2)
    cat = tps.shard_catalog(V)
    V.mul_(3.0)
    assert torch.equal(cat.V_sh, torch.ones(5, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tps.shard_catalog(V, dtype="float16")
    with pytest.raises(TypeError, match="Partitioner"):
        tps.shard_catalog(V, mesh=object())


# -- engine contracts -------------------------------------------------------


def test_serve_packs_requests_and_keeps_per_request_results():
    jm, tm = models(seed=9)
    tr = train_pairs(jm, seed=9)
    eng = ServingEngine(tm, k=5, train=tr, max_batch=256)
    rng = np.random.default_rng(0)
    users = real_users(tm)
    reqs = [rng.choice(users, int(rng.integers(1, 50))) for _ in range(25)]
    results = eng.serve(reqs)
    assert len(results) == len(reqs)
    for r, res in zip(reqs, results):
        assert isinstance(res, RecResult) and not res.degraded
        ids0, scores0 = tm.recommend(r, k=5, train=tr)
        np.testing.assert_array_equal(res[0], ids0)
        np.testing.assert_allclose(res[1], scores0, rtol=1e-6, atol=1e-6)
    assert eng.stats["microbatches"] < len(reqs)
    assert eng.stats["requests"] == len(reqs)


@pytest.mark.parametrize("retrieval", [None, "two_stage"])
def test_mixed_sizes_bounded_by_bucket_family(retrieval):
    """tests/test_serving_engine.py's pin: across many mixed-size requests
    the dispatched shape count is O(#buckets), not O(#requests)."""
    _, tm = models(seed=10)
    eng = ServingEngine(tm, k=4, max_batch=128, retrieval=retrieval)
    rng = np.random.default_rng(1)
    users = real_users(tm)
    for n in rng.integers(1, 200, 60):
        eng.recommend(rng.choice(users, int(n)))
    assert eng.bucket_family == (8, 16, 32, 64, 128)
    assert eng.executable_variants <= len(eng.bucket_family), eng.stats
    assert set(eng.stats["buckets"]) <= set(eng.bucket_family)
    assert eng.stats["requests"] == 60


def test_recommend_and_serve_align_past_prequeued_submits():
    _, tm = models(seed=11)
    eng = ServingEngine(tm, k=4)
    users = real_users(tm)
    r0, r1 = users[[1, 2, 3]], users[[7, 8]]
    eng.submit(r0)
    ids, _ = eng.recommend(r1)
    ids1, _ = tm.recommend(r1, k=4)
    assert ids.shape == (2, 4)
    np.testing.assert_array_equal(ids, ids1)
    eng.submit(r0)
    results = eng.serve([r1, r0])
    assert len(results) == 2
    np.testing.assert_array_equal(results[0][0], ids1)
    assert eng.flush() == []


def test_bucket_policy_validation_and_family():
    _, tm = models(seed=12)
    eng = ServingEngine(tm, k=4, min_bucket=4, max_batch=64)
    assert eng.bucket_family == (4, 8, 16, 32, 64)
    eng.recommend(real_users(tm, 3))
    assert set(eng.stats["buckets"]) <= set(eng.bucket_family)
    assert set(eng.stats["buckets"]) == {4}
    for kw in (dict(min_bucket=5), dict(max_batch=100),
               dict(min_bucket=32, max_batch=16)):
        with pytest.raises(ValueError):
            ServingEngine(tm, **kw)
    with pytest.raises(TypeError, match="RetrievalConfig"):
        ServingEngine(tm, retrieval="fast")


def test_mesh_and_user_store_are_not_ported():
    """Both are ported now (the name is kept from when they raised):
    ``mesh=`` takes the port's ``Partitioner`` (a JAX mesh is refused)
    and, on one rank, serves the lists of the engine without one (the
    multi-rank engine: tests/test_torch_mesh_serving.py); ``user_store=``:
    a tiered store holding the model's user rows (a few hot, the rest
    cold) serves the same lists as the engine's own table."""
    _, tm = models(seed=13)
    with pytest.raises(TypeError, match="Partitioner"):
        ServingEngine(tm, mesh=make_block_mesh(1))
    ids = real_users(tm)
    one = ServingEngine(tm, k=6, mesh=Partitioner(device="cpu"),
                        train=train_pairs(tm)).recommend(ids)
    plain = ServingEngine(tm, k=6, train=train_pairs(tm)).recommend(ids)
    np.testing.assert_array_equal(one[0], plain[0])
    np.testing.assert_array_equal(one[1], plain[1])
    store = TieredFactorStore(PseudoRandomFactorInitializer(8), capacity=8,
                              slot_capacity=16, device="cpu")
    rows = store.ensure(ids)
    np.testing.assert_array_equal(rows, np.arange(len(ids)))
    store.load_rows(rows, tm.U[:len(ids)])
    assert store.warm_rows(rows[:10]) == 10
    got = ServingEngine(tm, k=6, user_store=store).recommend(ids)
    want = ServingEngine(tm, k=6).recommend(ids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the micro-batch is padded to its bucket with repeated rows
    assert store.stats.serve_hits >= 10
    assert store.stats.serve_misses >= len(ids) - 10


def test_refresh_moves_the_version_and_serves_the_new_model():
    _, tm = models(seed=14)
    eng = ServingEngine(tm, k=4)
    uids = real_users(tm, 20)
    eng.recommend(uids)
    variants = eng.executable_variants
    v0 = eng.version
    assert eng.refresh() == v0  # nothing changed: the same token
    rng = np.random.default_rng(3)
    tm2 = dataclasses.replace(
        tm, U=torch.from_numpy(rng.normal(size=tuple(tm.U.shape)).astype(
            np.float32)),
        V=torch.from_numpy(rng.normal(size=tuple(tm.V.shape)).astype(
            np.float32)))
    seen = []
    eng.on_refresh = seen.append
    v1 = eng.refresh(tm2)
    assert v1 != v0 and seen == [v1] and eng.stats["refreshes"] == 3
    ids, scores = eng.recommend(uids)
    ids0, scores0 = tm2.recommend(uids, k=4)
    np.testing.assert_array_equal(ids, ids0)
    np.testing.assert_array_equal(scores, scores0)
    assert eng.executable_variants == variants  # the same shapes


@pytest.mark.parametrize("retrieval", [None, "two_stage"])
def test_in_place_write_is_invisible_until_refresh(retrieval):
    """The engine serves its own copies: ``model.V.add_(1)`` changes
    nothing served and nothing in the version until ``refresh()``, which
    then serves the new values under a new version."""
    _, tm = models(seed=15)
    eng = ServingEngine(tm, k=5, retrieval=retrieval)
    uids = real_users(tm, 30)
    before = eng.recommend(uids)
    v0 = eng.version
    tm.V.add_(1.0)
    tm.U.mul_(-1.0)
    again = eng.recommend(uids)
    np.testing.assert_array_equal(again[0], before[0])
    np.testing.assert_array_equal(again[1], before[1])
    assert again.catalog_version == v0 == eng.version
    v1 = eng.refresh()
    assert v1 != v0
    fresh = ServingEngine(tm, k=5, retrieval=retrieval).recommend(uids)
    after = eng.recommend(uids)
    np.testing.assert_array_equal(after[0], fresh[0])
    np.testing.assert_array_equal(after[1], fresh[1])
    assert after.catalog_version == v1


@pytest.mark.parametrize("retrieval", [None, "flat"])
def test_engine_delta_equals_full_refresh(retrieval):
    cfg = None if retrieval is None else RetrievalConfig(overfetch=4)
    _, tm_a = models(seed=16)
    _, tm_b = models(seed=16)
    rng = np.random.default_rng(12)
    item_rows = np.array([0, 17, 200, 255])
    user_rows = np.array([3, 57])
    V_new = rng.normal(size=(4, 8)).astype(np.float32)
    U_new = rng.normal(size=(2, 8)).astype(np.float32)
    eng_a = ServingEngine(tm_a, k=6, retrieval=cfg)
    uids = real_users(tm_a)
    eng_a.recommend(uids)
    variants = eng_a.executable_variants
    v0 = eng_a.version
    held_V = tm_a.V
    seen = []
    eng_a.on_refresh = seen.append
    v1 = eng_a.apply_delta(item_rows=item_rows, V_rows=V_new,
                           user_rows=user_rows, U_rows=U_new)
    assert v1 != v0 and seen == [v1] and eng_a.stats["delta_swaps"] == 1
    assert eng_a.executable_variants == variants
    assert tm_a.V is not held_V  # out of place: a held table is unchanged
    np.testing.assert_array_equal(held_V.numpy(), tm_b.V.numpy())
    tm_b.V = tm_b.V.index_copy(0, torch.from_numpy(item_rows),
                               torch.from_numpy(V_new))
    tm_b.U = tm_b.U.index_copy(0, torch.from_numpy(user_rows),
                               torch.from_numpy(U_new))
    eng_b = ServingEngine(tm_b, k=6, retrieval=cfg)
    ra, rb = eng_a.recommend(uids), eng_b.recommend(uids)
    np.testing.assert_array_equal(ra[0], rb[0])
    np.testing.assert_array_equal(ra[1], rb[1])
    assert ra.catalog_version == v1
    if cfg is not None:
        for f in ("q", "scale"):
            assert torch.equal(getattr(eng_a.retriever.catalog, f),
                               getattr(eng_b.retriever.catalog, f))
    # the patched model carries the delta into a later refresh
    eng_a.refresh()
    np.testing.assert_array_equal(eng_a.recommend(uids)[0], rb[0])


def test_engine_delta_matches_jax_engine_delta():
    jm, tm = models(seed=17)
    j = JEngine(jm, k=6, mesh=make_block_mesh(1),
                retrieval=JCfg(overfetch=4))
    t = ServingEngine(tm, k=6, retrieval=RetrievalConfig(overfetch=4))
    rng = np.random.default_rng(4)
    rows = np.array([2, 40, 41, 250])
    vals = rng.normal(size=(4, 8)).astype(np.float32)
    j.apply_delta(item_rows=rows, V_rows=vals)
    t.apply_delta(item_rows=rows, V_rows=vals)
    for f in ("q", "scale"):
        np.testing.assert_array_equal(
            getattr(t.retriever.catalog, f).numpy(),
            np.asarray(getattr(j.retriever.catalog, f)))
    uids = real_users(tm)
    assert_results_match(t.recommend(uids), j.recommend(uids))


@pytest.mark.parametrize("retrieval", [None, "two_stage"])
def test_deferred_deltas_equal_eager_ones(retrieval):
    _, tm_a = models(seed=18)
    _, tm_b = models(seed=18)
    eager = ServingEngine(tm_a, k=5, retrieval=retrieval)
    deferred = ServingEngine(tm_b, k=5, retrieval=retrieval)
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 256, 6), rng.normal(size=(6, 8)),
                rng.integers(0, 60, 3), rng.normal(size=(3, 8)))
               for _ in range(3)]
    batches.append((np.array([5, 5]), rng.normal(size=(2, 8)), None, None))
    v0 = deferred.version
    for ir, iv, ur, uv in batches:
        for i, (r, v) in enumerate(zip(ir, iv)):  # arrival order
            eager.apply_delta(item_rows=[r], V_rows=v[None])
        if ur is not None:
            eager.apply_delta(user_rows=ur, U_rows=uv)
        assert deferred.apply_delta(item_rows=ir, V_rows=iv, user_rows=ur,
                                    U_rows=uv, defer=True) == v0
    pending = deferred.pending_delta_rows
    assert pending == (len({int(r) for b in batches for r in b[0]})
                       + len({int(r) for b in batches[:3] for r in b[2]}))
    assert deferred.stats["deferred_delta_rows"] == 6 * 3 + 2 + 9
    v1 = deferred.flush_deltas()
    assert v1 != v0 and deferred.pending_delta_rows == 0
    assert deferred.stats["delta_flushes"] == 1
    assert deferred.flush_deltas() == v1  # nothing pending: no-op
    uids = real_users(tm_a)
    ra, rb = eager.recommend(uids), deferred.recommend(uids)
    np.testing.assert_array_equal(ra[0], rb[0])
    np.testing.assert_array_equal(ra[1], rb[1])
    assert torch.equal(tm_a.V, tm_b.V) and torch.equal(tm_a.U, tm_b.U)


def test_refresh_drops_deferred_deltas():
    _, tm = models(seed=19)
    eng = ServingEngine(tm, k=5)
    before = tm.V.clone()
    eng.apply_delta(item_rows=[1, 2], V_rows=np.ones((2, 8)), defer=True)
    assert eng.pending_delta_rows == 2
    eng.refresh()
    assert eng.pending_delta_rows == 0
    eng.flush_deltas()
    assert torch.equal(tm.V, before)


def test_delta_rejects_vocab_growth_eager_and_deferred():
    _, tm = models(num_users=20, num_items=64, rank=4, seed=20)
    eng = ServingEngine(tm, k=4)
    for defer in (False, True):
        with pytest.raises(ValueError, match="vocab grew"):
            eng.apply_delta(item_rows=np.array([64]),
                            V_rows=np.zeros((1, 4), np.float32), defer=defer)
        with pytest.raises(ValueError, match="vocab grew"):
            eng.apply_delta(user_rows=np.array([20]),
                            U_rows=np.zeros((1, 4), np.float32), defer=defer)
        # a rejected delta leaves nothing behind, on either side
        with pytest.raises(ValueError, match="vocab grew"):
            eng.apply_delta(item_rows=np.array([1]),
                            V_rows=np.zeros((1, 4), np.float32),
                            user_rows=np.array([20]),
                            U_rows=np.zeros((1, 4), np.float32), defer=defer)
    assert eng.pending_delta_rows == 0 and eng.stats["delta_swaps"] == 0


def test_fast_path_conventions_and_exclusions():
    jm, tm = models(num_users=40, num_items=128, seed=21)
    tu, ti = train_pairs(jm, n=300, seed=5)
    eng = ServingEngine(tm, k=10, train=(tu, ti),
                        retrieval=RetrievalConfig(overfetch=8))
    uids = np.concatenate([real_users(tm), [777_777]])
    res = eng.recommend(uids, return_mask=True)
    ids, scores, mask = res
    assert isinstance(res, RecResult) and res.degraded is False
    assert res.catalog_version == eng.version
    assert not mask[-1] and (ids[-1] == -1).all() and (scores[-1] == 0).all()
    excluded = set(zip(tu.tolist(), ti.tolist()))
    for q, u in enumerate(uids[:-1]):
        for i in ids[q]:
            if i >= 0:
                assert (int(u), int(i)) not in excluded


def test_concurrent_refresh_never_tears_a_flush():
    """A refresh from another thread never rebinds the catalog mid-flush:
    every result equals exactly one model's answer."""
    _, tm = models(seed=22)
    rng = np.random.default_rng(5)
    other = dataclasses.replace(
        tm, U=torch.from_numpy(rng.normal(size=tuple(tm.U.shape)).astype(
            np.float32)),
        V=torch.from_numpy(rng.normal(size=tuple(tm.V.shape)).astype(
            np.float32)))
    eng = ServingEngine(tm, k=4, max_batch=16)
    uids = real_users(tm, 40)
    answers = {m.recommend(uids, k=4)[0].tobytes() for m in (tm, other)}
    stop = threading.Event()

    def flip():
        flip_to = other
        while not stop.is_set():
            eng.refresh(flip_to)
            flip_to = tm if flip_to is other else other

    t = threading.Thread(target=flip, daemon=True)
    t.start()
    try:
        for _ in range(30):
            ids, _ = eng.recommend(uids)
            assert ids.tobytes() in answers, "cross-version result"
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


def test_concurrent_recommend_threads_get_their_own_results():
    _, tm = models(seed=23)
    eng = ServingEngine(tm, k=4)
    users = real_users(tm)
    uid_sets = [users[i:i + 6] for i in range(8)]
    expected = [tm.recommend(u, k=4)[0] for u in uid_sets]
    errors = []

    def worker(i):
        try:
            for _ in range(10):
                ids, _ = eng.recommend(uid_sets[i])
                np.testing.assert_array_equal(ids, expected[i])
        except Exception as e:  # surfaced after join
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(uid_sets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_slo_tracker_records_each_request():
    from large_scale_recommendation_tpu_torch.obs.health import SLOTracker

    _, tm = models(seed=24)
    slo = SLOTracker(target_s=60.0, objective=0.9, window=16)
    eng = ServingEngine(tm, k=4, slo=slo)
    users = real_users(tm)
    eng.serve([users[:3], users[3:5], users[5:9]])
    assert slo.count == 3 and slo.violations == 0
    assert eng.meter.total_elements == 9 and eng.meter.rate > 0


@pytest.mark.parametrize("retrieval", [None, "two_stage"])
def test_serving_pipeline_runs_in_the_serve_rows_guard(monkeypatch,
                                                       retrieval):
    """Each flush's scoring pipeline enters the transfer guard's
    ``serving.serve_rows`` scope, as many times as the JAX engine's; with a
    ``log`` ledger the sync-debug mode is raised around each pipeline run
    and put back, and (on the CPU) nothing is counted."""
    from large_scale_recommendation_tpu.serving import engine as jeng
    from large_scale_recommendation_tpu_torch import obs
    from large_scale_recommendation_tpu_torch.obs import transfers
    from large_scale_recommendation_tpu_torch.serving import engine as peng

    entered = {"jax": [], "port": []}
    for name, mod in (("jax", jeng), ("port", peng)):
        real = mod.guard_scope
        monkeypatch.setattr(
            mod, "guard_scope",
            lambda site, real=real, seen=entered[name]:
            seen.append(site) or real(site))
    modes = []
    monkeypatch.setattr(transfers, "_set_sync_debug_mode", modes.append)
    jm, tm = models(num_items=1024, seed=4)
    kw = {} if retrieval is None else dict(retrieval=RetrievalConfig())
    jkw = {} if retrieval is None else dict(retrieval=JCfg())
    j = JEngine(jm, k=5, mesh=make_block_mesh(1), max_batch=32, **jkw)
    prev = obs.get_transfers()
    ledger = obs.enable_transfers(guard="log", watch_hot=False)
    try:
        t = ServingEngine(tm, k=5, max_batch=32, **kw)
        rng = np.random.default_rng(5)
        reqs = [rng.choice(real_users(tm), int(rng.integers(1, 40)))
                for _ in range(12)]
        for _ in range(2):
            res, jres = t.serve(reqs), j.serve(reqs)
        for r, jr in zip(res, jres):
            np.testing.assert_array_equal(r[0], np.asarray(jr[0]))
    finally:
        obs.set_transfers(prev)
    assert entered["port"] == entered["jax"] != []
    assert set(entered["port"]) == {"serving.serve_rows"}
    assert modes == [1, 0] * len(entered["port"])
    assert ledger.implicit_total == 0
