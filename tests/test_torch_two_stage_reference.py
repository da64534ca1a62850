"""The serving engine's flat int8 two-stage path against the benchmark's
plain reference (``portbench/reference/two_stage.py``, plain torch that
imports nothing of the port) on seeded random factors: the same candidate
sets and answers away from near-ties, every served score the item's exact
score, recall against the exact top-K, exclusions held, and the
retriever's two stage spans with their counters."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.data.blocking import flat_index
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.serving import retrieval
from large_scale_recommendation_tpu_torch.serving.engine import (
    ServingEngine,
)
from large_scale_recommendation_tpu_torch.serving.retrieval import (
    RetrievalConfig,
)
from portbench.reference import two_stage
from portbench.reference.topk import _exclusions, topk_gaps

N_USERS, N_ITEMS, RANK, K, OVERFETCH = 400, 3000, 64, 50, 4
KC = K * OVERFETCH
BUCKET = 32  # the retriever's chunk: 96 served users are 3 full chunks
SERVED = 96
NEAR_TIE = 1e-5  # stage-1 / rescored scores closer than this may swap


def _problem(seed):
    """Seeded factors of unit-variance scores, and training pairs whose
    count a user falls from ~300 (user 0) to a few (the hot users first,
    as the benchmark's skew draws them)."""
    g = torch.Generator().manual_seed(seed)
    sd = RANK ** -0.25
    U = sd * torch.randn((N_USERS, RANK), generator=g)
    V = sd * torch.randn((N_ITEMS, RANK), generator=g)
    rng = np.random.default_rng(seed)
    counts = (300 * np.exp(-np.arange(N_USERS) / 60.0)).astype(int) + 1
    tu = np.repeat(np.arange(N_USERS), counts)
    ti = rng.integers(0, N_ITEMS, tu.shape[0])
    users = rng.choice(N_USERS, SERVED, replace=False)
    users[:8] = np.arange(8)  # the longest exclusion lists among them
    return U, V, tu, ti, users


def _engine(U, V, tu, ti):
    model = MFModel(U=U, V=V, users=flat_index(np.arange(N_USERS)),
                    items=flat_index(np.arange(N_ITEMS)))
    return ServingEngine(
        model, k=K, train=(tu, ti), max_batch=128,
        retrieval=RetrievalConfig(n_clusters=None, overfetch=OVERFETCH,
                                  max_bucket=BUCKET))


def _served(seed, monkeypatch):
    """The engine's answers for the served users, and the candidate rows
    its stage 1 produced for them (chunk by chunk, in serving order)."""
    U, V, tu, ti, users = _problem(seed)
    engine = _engine(U, V, tu, ti)
    cands = []
    orig = retrieval._stage1_flat

    def record(*a, **k):
        out = orig(*a, **k)
        cands.append(out[1])
        return out

    monkeypatch.setattr(retrieval, "_stage1_flat", record)
    out = engine.serve([users])[0]
    ids, scores = (np.asarray(x) for x in out[:2])
    return (U, V, tu, ti, users, torch.from_numpy(ids),
            torch.from_numpy(scores), torch.cat(cands))


def _reference(U, V, tu, ti, users):
    tu_t, ti_t = torch.from_numpy(tu), torch.from_numpy(ti)
    order = torch.argsort(tu_t, stable=True)
    starts = torch.searchsorted(tu_t[order], torch.arange(N_USERS + 1))
    ub = torch.from_numpy(users).long()
    r, c = _exclusions(starts, ti_t[order], ub)
    exact = two_stage.exact_scores(U[ub], V, r, c)
    cand, ids, scores = two_stage.two_stage(U[ub], V, exact, r, c, K,
                                            OVERFETCH)
    return exact, cand, ids, scores, r, c


def _stage1_ref(U, V, users, r, c):
    qV, sV = two_stage.quantize(V)
    qU, sU = two_stage.quantize(U[torch.from_numpy(users).long()])
    s1 = (qU @ qV.T) * (sU[:, None] * sV[None, :])
    s1[r, c] = -float("inf")
    return s1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_sets_equal_away_from_near_ties(seed, monkeypatch):
    U, V, tu, ti, users, _, _, cand = _served(seed, monkeypatch)
    _, ref_cand, _, _, r, c = _reference(U, V, tu, ti, users)
    s1 = _stage1_ref(U, V, users, r, c)
    edge = torch.topk(s1, KC + 1, dim=1).values
    gap = edge[:, KC - 1] - edge[:, KC]  # the kc-th over the next
    same = 0
    for j in range(SERVED):
        if set(cand[j].tolist()) == set(ref_cand[j].tolist()):
            same += 1
        else:
            assert gap[j] < NEAR_TIE, (j, float(gap[j]))
    assert same >= SERVED - 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_answers_equal_away_from_near_ties(seed, monkeypatch):
    U, V, tu, ti, users, ids, scores, _ = _served(seed, monkeypatch)
    exact, ref_cand, ref_ids, ref_scores, _, _ = _reference(U, V, tu, ti,
                                                            users)
    rescored = torch.sort(exact.gather(1, ref_cand), dim=1,
                          descending=True).values
    gap = rescored[:, K - 1] - rescored[:, K]
    for j in range(SERVED):
        if gap[j] >= NEAR_TIE:
            assert set(ids[j].tolist()) == set(ref_ids[j].tolist()), j
    # position by position where neighbouring scores are apart
    gaps = (ref_scores[:, :-1] - ref_scores[:, 1:]) >= NEAR_TIE
    edge = torch.ones((SERVED, 1), dtype=torch.bool)
    apart = (torch.cat([gaps, edge], dim=1)
             & torch.cat([edge, gaps], dim=1))
    assert torch.equal(ids[apart], ref_ids[apart])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_served_scores_are_the_items_exact_scores(seed, monkeypatch):
    U, V, tu, ti, users, ids, scores, _ = _served(seed, monkeypatch)
    exact, _, _, ref_scores, _, _ = _reference(U, V, tu, ti, users)
    got_exact = exact.gather(1, ids)
    assert torch.isfinite(got_exact).all()
    # f32 against float64, as a share of the largest best score (the
    # benchmark's score_gap): 64 f32 products summed, ~3e-7 of a score
    scale = float(ref_scores[:, 0].abs().max())
    assert float((scores.double() - got_exact).abs().max()) <= 1e-6 * scale
    assert float((scores.double() - ref_scores).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recall_and_exclusions_against_the_exact_answer(seed, monkeypatch):
    U, V, tu, ti, users, ids, scores, _ = _served(seed, monkeypatch)
    tu_t, ti_t = torch.from_numpy(tu), torch.from_numpy(ti)
    ub = torch.from_numpy(users).long()
    bad, _, score = topk_gaps(U, V, tu_t, ti_t, ub, ids, scores, K)
    assert bad == 0
    assert score <= 1e-6
    got, ref = two_stage.recalls(U, V, tu_t, ti_t, ub, ids, K, OVERFETCH,
                                 block=40)
    assert got >= 0.95 and ref >= 0.95
    assert abs(got - ref) <= 1.0 / K  # one slot of one user at most


def test_reference_recall_reads_a_lost_half():
    """The recall of answers that lack every other exact item reads about
    a half: the comparison sees what it is there to see."""
    U, V, tu, ti, users = _problem(5)
    exact, _, _, _, _, _ = _reference(U, V, tu, ti, users)
    top = torch.topk(exact, 2 * K, dim=1).indices[:, ::2]
    got, _ = two_stage.recalls(U, V, torch.from_numpy(tu),
                               torch.from_numpy(ti),
                               torch.from_numpy(users).long(), top, K,
                               OVERFETCH)
    assert got == pytest.approx(0.5, abs=0.02)


def test_quantize_matches_the_program():
    """The reference's codes and scales are the program's, written
    again."""
    X = torch.randn((257, RANK), generator=torch.Generator().manual_seed(3))
    X[5] = 0.0
    q, s = retrieval.quantize_rows(X)
    rq, rs = two_stage.quantize(X)
    assert torch.equal(q.double(), rq)
    assert torch.equal(s.double(), rs)


@pytest.fixture
def live_spans():
    prev = obs.get_tracer()
    obs.set_tracer(ptr.NULL_TRACER)
    ptr.reset_span_totals()
    yield
    obs.set_tracer(prev)
    ptr.reset_span_totals()


def test_stage_spans_and_their_counters(live_spans):
    U, V, tu, ti, users = _problem(0)
    engine = _engine(U, V, tu, ti)
    requests = [users[:SERVED - 11]]  # 85 users: chunks of 32, 32, 21 → 32
    with profile(activities=[ProfilerActivity.CPU]):
        engine.serve(requests)
    tot = ptr.span_totals()
    s1, s2 = tot["serving/stage1"], tot["serving/stage2"]
    assert s1["count"] == s2["count"] == 3
    assert s1["args"] == {"rows": SERVED - 11, "padded": 3 * BUCKET,
                          "items": 3 * N_ITEMS, "fused": SERVED - 11}
    assert s2["args"] == {"candidates": 3 * BUCKET * KC}
    assert "device_ms" not in s1 and "device_ms" not in s2  # CPU only
    assert tot["serving/score"]["count"] == 3


def test_stage_spans_count_a_direct_call_whole(live_spans):
    U, V, tu, ti, _ = _problem(1)
    ret = retrieval.TwoStageRetriever(
        V, config=RetrievalConfig(overfetch=OVERFETCH, max_bucket=BUCKET))
    excl = (torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32),
            torch.full((8,), float("inf")))
    with profile(activities=[ProfilerActivity.CPU]):
        ret.topk(U[:16], excl, k=K)
    tot = ptr.span_totals()
    assert tot["serving/stage1"]["args"] == {"rows": 16, "padded": 16,
                                             "items": N_ITEMS, "fused": 16}


def test_stage_spans_cost_nothing_unheard(live_spans):
    U, V, tu, ti, users = _problem(2)
    _engine(U, V, tu, ti).serve([users[:8]])
    assert ptr.span_totals() == {}
