"""Rank sharding on the port's mesh: data 2 × model 2 (4 gloo ranks) against
model 1 at the same k = 2 (2 gloo ranks), as the JAX package holds it
(tests/test_rank_sharding.py:68-79), and against the JAX package's own
data 2 × model 2 mesh on the virtual CPU devices.

Bars: DSGD (``kernel="torch"``: the prediction dot summed over the model
group) 1e-5 max-abs between the two grids (the sum's order; the JAX bar),
and against JAX's rank-sharded mesh the f32 mesh bar of
tests/test_torch_dsgd_mesh.py (1e-5 per stratum swept: 2 strata × 3
sweeps); ALS explicit 1e-5 between the grids (its solves are row-local),
implicit (α = 1) rtol 1e-5 / atol 1e-5 (its VᵀV gram is split over the
group and summed: another order, amplified by each solve; at α = 40 the
amplification passes 5e-5 relative), and
the ALS fit bar of tests/test_torch_als.py (rtol 2e-3 / atol 2e-4) against
JAX; serving top-K ids equal, scores within 1e-5. The refusals: the CUDA
route on a rank-sharded grid and ranks that do not split.
"""

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.als import ALS as JALS
from large_scale_recommendation_tpu.models.als import ALSConfig as JALSConfig
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JConfig
from large_scale_recommendation_tpu.parallel.als_mesh import (
    MeshALS as JMeshALS,
)
from large_scale_recommendation_tpu.parallel.dsgd_mesh import (
    MeshDSGD as JMeshDSGD,
)
from large_scale_recommendation_tpu.parallel.dsgd_mesh import (
    MeshDSGDConfig as JMeshConfig,
)
from large_scale_recommendation_tpu.parallel.partitioner import (
    Partitioner as JPartitioner,
)
from large_scale_recommendation_tpu.parallel.serving import (
    mesh_top_k_recommend as j_topk,
)
from large_scale_recommendation_tpu.parallel.serving import (
    shard_catalog as j_catalog,
)

import _torch_mesh_ranks as ranks

NU, NI = 96, 64
DSGD_KW = dict(num_factors=8, lambda_=0.01, iterations=3, learning_rate=0.05,
               lr_schedule="constant", seed=0, minibatch_size=64,
               init_scale=0.3)
ALS_KW = dict(num_factors=8, lambda_=0.1, iterations=2, seed=0)
ALPHA = 1.0  # implicit confidence 1 + α·|r|
GRID_TOL = 1e-5
FIT = dict(rtol=2e-3, atol=2e-4)


def _ratings():
    return SyntheticMFGenerator(num_users=NU, num_items=NI, rank=4,
                                noise=0.1, seed=0).generate(6000)


def _dsgd_init(train):
    """JAX's initial DSGD tables of the k = 2 blocking."""
    problem = jblk.block_problem(train, num_blocks=2, seed=0,
                                 minibatch_multiple=64)
    return tuple(np.asarray(a) for a in JDSGD(JConfig(
        num_factors=8, seed=0, init_scale=0.3))._init_factors(problem))


def _als_init(train, cfg):
    """JAX's initial ALS tables of this blocking (k = 2)."""
    ru, ri, _, rw = train.to_numpy()
    real = rw > 0
    users = jblk.build_id_index(ru[real], num_blocks=2, seed=0)
    items = jblk.build_id_index(ri[real], num_blocks=2, seed=1)
    return tuple(np.asarray(a) for a in JALS(JALSConfig(**cfg))
                 ._init_factors(users, items))


def _serve_tables():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(40, 8)).astype(np.float32),
            rng.normal(size=(64, 8)).astype(np.float32))


def _interactions(train):
    """Implicit-feedback strengths: |r| (a negative strength makes the
    confidence 1 + α·r negative and the systems indefinite)."""
    ru, ri, rv, _ = train.to_numpy()
    return ru, ri, np.abs(rv).astype(np.float32)


def _jobs(m, train):
    ratings = tuple(np.asarray(a) for a in train.to_numpy()[:3])
    implicit = dict(ALS_KW, implicit_alpha=ALPHA)
    U, V = _serve_tables()
    return [
        dict(op="dsgd", m=m, cfg=dict(DSGD_KW, kernel="torch"),
             ratings=ratings, init=_dsgd_init(train)),
        dict(op="als", m=m, cfg=ALS_KW, ratings=ratings,
             init=_als_init(train, ALS_KW)),
        dict(op="als", m=m, cfg=implicit, ratings=_interactions(train),
             init=_als_init(train, implicit)),
        dict(op="serve", m=m, U=U, V=V, rows=np.arange(40, dtype=np.int32),
             k=10),
    ]


def _retrieval_tables():
    rng = np.random.default_rng(2)
    V = rng.normal(size=(512, 16)).astype(np.float32)
    Q = rng.normal(size=(32, 16)).astype(np.float32)
    delta = (np.array([3, 100, 400]),
             rng.normal(size=(3, 16)).astype(np.float32))
    train = (rng.integers(0, 32, 200), rng.integers(0, 512, 200))
    return V, Q, delta, train


RETRIEVAL = [(m, nc) for m in (2, 4) for nc in (None, 8)]


@pytest.fixture(scope="module")
def grids():
    train = _ratings()
    V, Q, delta, pairs = _retrieval_tables()
    sharded = ranks.run_world(4, _jobs(2, train) + [dict(
        op="refusals", m=2, cfg=DSGD_KW,
        ratings=tuple(np.asarray(a) for a in train.to_numpy()[:3]))] + [
        dict(op="retriever", m=m, n_clusters=nc, V=V, Q=Q, delta=delta,
             train=pairs) for m, nc in RETRIEVAL])
    base = ranks.run_world(2, _jobs(1, train))
    return dict(train=train, sharded=sharded, base=base)


@pytest.mark.parametrize("job", [0, 1, 2], ids=["dsgd", "als_explicit",
                                                "als_implicit"])
def test_model_2_equals_model_1_at_equal_k(grids, job):
    shd, base = grids["sharded"][0][job], grids["base"][0][job]
    for key in ("U", "V"):
        assert np.isfinite(shd[key]).all(), key
        if job == 2:  # the split gram's sum order, through the solve
            np.testing.assert_allclose(shd[key], base[key], rtol=GRID_TOL,
                                       atol=GRID_TOL)
        else:
            assert np.abs(shd[key] - base[key]).max() <= GRID_TOL, key
    # each rank holds rank/2 columns of its row block
    for r, res in enumerate(grids["sharded"]):
        di, mi = divmod(r, 2)
        rpb = shd["U"].shape[0] // 2
        np.testing.assert_array_equal(
            res[job]["U_l"], shd["U"][di * rpb:(di + 1) * rpb,
                                      mi * 4:(mi + 1) * 4])


def test_rank_sharded_dsgd_matches_jax_rank_sharded_mesh(grids):
    jm = JMeshDSGD(JMeshConfig(**DSGD_KW, kernel="xla"),
                   partitioner=JPartitioner(num_devices=4,
                                            model_parallel=2)).fit(
        grids["train"])
    got = grids["sharded"][0][0]
    tol = 1e-5 * 2 * DSGD_KW["iterations"]  # per stratum swept
    for key, want in (("U", jm.U), ("V", jm.V)):
        assert np.abs(got[key] - np.asarray(want)).max() <= tol, key


@pytest.mark.parametrize("job,implicit", [(1, False), (2, True)],
                         ids=["explicit", "implicit"])
def test_rank_sharded_als_matches_jax(grids, job, implicit):
    cfg = JALSConfig(**ALS_KW, implicit_alpha=ALPHA if implicit else None)
    train = grids["train"]
    if implicit:
        train = JRatings.from_arrays(*_interactions(train))
    jm = JMeshALS(cfg, partitioner=JPartitioner(
        num_devices=4, model_parallel=2)).fit(train)
    got = grids["sharded"][0][job]
    assert np.isfinite(got["U"]).all() and np.isfinite(got["V"]).all()
    np.testing.assert_allclose(got["U"], np.asarray(jm.U), **FIT)
    np.testing.assert_allclose(got["V"], np.asarray(jm.V), **FIT)


@pytest.mark.parametrize("grid", ["sharded", "base"])
def test_serving_topk_equal_across_grids_and_jax(grids, grid):
    U, V = _serve_tables()
    jp = JPartitioner(num_devices=4, model_parallel=2)
    ids_j, sc_j = j_topk(U, V, np.arange(40, dtype=np.int32), k=10,
                         catalog=j_catalog(V, jp))
    for res in grids[grid]:
        got = res[3]
        np.testing.assert_array_equal(got["rows"], np.asarray(ids_j))
        np.testing.assert_allclose(got["scores"], np.asarray(sc_j),
                                   atol=GRID_TOL, rtol=0)
    assert grids["sharded"][0][3]["local_shape"] == (32, 4)
    assert grids["base"][0][3]["local_shape"] == (32, 8)


def test_refusals(grids):
    for res in grids["sharded"]:
        got = res[4]
        assert got["cuda_kernel"][0] == "NotImplementedError"
        assert "model" in got["cuda_kernel"][1]
        assert got["rank_divisible"][0] == "ValueError"
        assert "divisible" in got["rank_divisible"][1]
        assert got["als_divisible"][0] == "ValueError"
        assert "divisible" in got["als_divisible"][1]


@pytest.mark.parametrize("i", range(len(RETRIEVAL)),
                         ids=[f"m{m}_{'clustered' if nc else 'flat'}"
                              for m, nc in RETRIEVAL])
def test_rank_sharded_two_stage_retriever(grids, i):
    """Codes are quantized on full rows and the int8 partials sum exactly,
    so stage 1 keeps the same candidates; the f32 rescore sums its
    partials in another order: ids equal, scores within 1e-5; the same
    after ``apply_delta``. JAX's rank-sharded retriever gives the same
    ids (tests/test_rank_sharding.py holds it to its own model-1 run)."""
    from large_scale_recommendation_tpu.serving.retrieval import (
        RetrievalConfig as JRetrievalConfig,
    )
    from large_scale_recommendation_tpu.serving.retrieval import (
        TwoStageRetriever as JRetriever,
    )

    m, nc = RETRIEVAL[i]
    V, Q, _, pairs = _retrieval_tables()
    for r, res in enumerate(grids["sharded"]):
        got = res[5 + i]
        for (sv, sr), (bv, br) in zip(got["sharded"], got["base"]):
            np.testing.assert_array_equal(sr, br)
            np.testing.assert_allclose(sv, bv, atol=GRID_TOL, rtol=0)
        assert got["V_shape"] == (512, 16 // m)
        assert got["shapes"][("slab_q" if nc else "q")][-1] == 16 // m
    jr = JRetriever(V, config=JRetrievalConfig(n_clusters=nc, kmeans_iters=2),
                    partitioner=JPartitioner(num_devices=8,
                                             model_parallel=m))
    if nc is None:  # the clustered index's k-means differs by design
        from large_scale_recommendation_tpu.utils.metrics import (
            _exclusion_builder as j_excl,
        )

        excl = j_excl(pairs[0], pairs[1], 32)(np.arange(32), 32)
        jv, jrows = jr.topk(Q, excl, k=10)
        got = grids["sharded"][0][5 + i]["sharded"][0]
        np.testing.assert_array_equal(got[1], np.asarray(jrows))
        np.testing.assert_allclose(got[0], np.asarray(jv), atol=GRID_TOL,
                                   rtol=0)
