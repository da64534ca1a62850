"""The port's mesh serving on 2 and 4 gloo ranks against the JAX package's
``mesh_top_k_recommend`` on ``Partitioner(num_devices=2 | 4)`` (virtual
CPU devices): plain lists, train exclusions with a masked catalog, a
catalog smaller than k per shard (mesh padding surfaces as row 0 / -inf),
a bf16 catalog, an ``apply_delta`` equal to a rebuild,
``MFModel.recommend(mesh=)`` equal to the plain ``recommend`` and to the
JAX model's, and ``ServingEngine(mesh=)`` equal to the single-card engine
and to the JAX engine on its mesh. Bars: top-K ids equal and scores within 1e-5·max(1, |s|),
tie-aware (``test_torch_retrieval.assert_topk_tie_aware``); every rank
returns the same lists.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.mf import MFModel as JMFModel
from large_scale_recommendation_tpu.parallel.partitioner import (
    Partitioner as JPartitioner,
)
from large_scale_recommendation_tpu.parallel.serving import (
    mesh_top_k_recommend as j_topk,
)
from large_scale_recommendation_tpu.parallel.serving import (
    shard_catalog as j_catalog,
)
from large_scale_recommendation_tpu.serving.engine import (
    ServingEngine as JEngine,
)
from large_scale_recommendation_tpu_torch.parallel import serving as psrv
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)

import _torch_mesh_ranks as ranks
from test_torch_retrieval import assert_topk_tie_aware

NU, NI, R = 60, 100, 8


def _tables(ni=NI):
    rng = np.random.default_rng(5)
    return (rng.normal(size=(NU, R)).astype(np.float32),
            rng.normal(size=(ni, R)).astype(np.float32))


def _train():
    rng = np.random.default_rng(6)
    return (rng.integers(0, NU, 400).astype(np.int64),
            rng.integers(0, NI, 400).astype(np.int64))


def _mask():
    return np.arange(NI) % 7 != 3


def _index(ids):
    ix = jblk.build_id_index(ids, num_blocks=1, seed=0)
    return ix, {f: np.asarray(getattr(ix, f)) for f in (
        "ids", "omega", "sorted_ids", "sorted_rows")} | dict(
        num_blocks=int(ix.num_blocks), rows_per_block=int(ix.rows_per_block))


CASES = {
    "plain": dict(k=10),
    "excluded_masked": dict(k=10, train=True, mask=True),
    "small_catalog": dict(k=10, ni=6),
    "bf16": dict(k=10, dtype="bfloat16"),
}


def _serve_job(case):
    U, V = _tables(case.get("ni", NI))
    tu, ti = _train() if case.get("train") else (None, None)
    return dict(op="serve", U=U, V=V, rows=np.arange(NU, dtype=np.int32),
                k=case["k"], train_u=tu, train_i=ti, chunk=16,
                item_mask=_mask() if case.get("mask") else None,
                dtype=case.get("dtype"))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    k = request.param
    jobs = [_serve_job(c) for c in CASES.values()]
    rows = np.array([3, 17, 42, 5])
    jobs.append(dict(_serve_job(CASES["plain"]), delta=(
        rows, np.random.default_rng(9).normal(size=(4, R)).astype(
            np.float32))))
    users, udict = _index(np.arange(NU) * 3)
    items, idict = _index(np.arange(NI) * 2 + 1)
    rng = np.random.default_rng(8)  # tables of the indexes' (padded) rows
    U = rng.normal(size=(len(users.ids), R)).astype(np.float32)
    V = rng.normal(size=(len(items.ids), R)).astype(np.float32)
    uids = np.concatenate([np.arange(NU) * 3, [-5, 10**6]])
    jobs.append(dict(op="recommend", U=U, V=V, users=udict, items=idict,
                     user_ids=uids, k=7,
                     train=(np.arange(NU) * 3, (np.arange(NU) % NI) * 2 + 1)))
    jmodel = JMFModel(U=jnp.asarray(U), V=jnp.asarray(V), users=users,
                      items=items)
    train = jobs[-1]["train"]
    jrec = jmodel.recommend(uids, k=7, train=train,
                            mesh=JPartitioner(num_devices=k))
    requests = [uids[a:a + n] for a, n in ((0, 3), (3, 20), (23, 39))]
    eng = dict(op="engine", U=U, V=V, users=udict, items=idict, k=7,
               train=train, requests=requests)
    jobs.append(dict(eng, delta=(np.array([1, 5, 40]), np.random.default_rng(
        2).normal(size=(3, R)).astype(np.float32))))
    jobs.append(dict(eng, two_stage=True))
    jeng = JEngine(jmodel, k=7, mesh=JPartitioner(num_devices=k),
                   train=train, max_batch=32).serve(requests)
    return k, ranks.run_world(k, jobs), (jrec, jeng)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_topk_matches_jax(world, name):
    k, out, _ = world
    case = CASES[name]
    job = _serve_job(case)
    cat = j_catalog(job["V"], JPartitioner(num_devices=k),
                    item_mask=job["item_mask"], dtype=job["dtype"])
    jr, js = j_topk(job["U"], job["V"], job["rows"], k=job["k"],
                    train_u=job["train_u"], train_i=job["train_i"],
                    chunk=16, catalog=cat)
    got = out[0][list(CASES).index(name)]
    assert got["rows_per_shard"] == cat.rows_per_shard
    assert_topk_tie_aware(got["rows"], got["scores"], np.asarray(jr),
                          np.asarray(js))
    for r in range(k):
        np.testing.assert_array_equal(out[r][list(CASES).index(name)]
                                      ["rows"], got["rows"])
    if name == "small_catalog":  # 6 items, k = 10: padding comes back
        assert np.isfinite(got["scores"][:, :6]).all()
        assert np.isneginf(got["scores"][:, 6:]).all()
        assert (got["rows"][:, 6:] == 0).all()
    if name == "excluded_masked":
        tu, ti = job["train_u"], job["train_i"]
        seen = set(zip(tu.tolist(), ti.tolist()))
        masked = ~job["item_mask"]
        for u in range(NU):
            real = got["scores"][u] > -1e29
            for i in got["rows"][u][real]:
                assert (u, int(i)) not in seen and not masked[i]


def test_delta_equals_rebuild(world):
    k, out, _ = world
    for r in range(k):
        assert out[r][len(CASES)]["delta_equal"] is True


def test_model_recommend_over_the_mesh(world):
    k, out, (jrec, _) = world
    got = out[0][len(CASES) + 1]
    for ids, scores in (got["mesh"], got["again"]):
        assert_topk_tie_aware(ids, scores, got["plain"][0], got["plain"][1])
        assert_topk_tie_aware(ids, scores, np.asarray(jrec[0]),
                              np.asarray(jrec[1]))
    assert (got["mesh"][0][-2:] == -1).all()  # unknown users


def test_catalog_without_a_mesh_is_refused_by_the_mesh_path():
    U, V = _tables()
    import torch

    cat = psrv.shard_catalog(torch.from_numpy(V))
    with pytest.raises(ValueError, match="mesh catalog"):
        psrv.mesh_top_k_recommend(torch.from_numpy(U), None, [0, 1],
                                  catalog=cat)
    one = Partitioner(device="cpu")
    assert psrv.mesh_supports_donation(one) is False
    rows, scores = psrv.mesh_top_k_recommend(
        torch.from_numpy(U), torch.from_numpy(V), np.arange(5), k=4,
        mesh=one)
    assert rows.shape == (5, 4) and np.isfinite(scores).all()


def test_engine_over_the_mesh(world):
    """``ServingEngine(mesh=)``: every rank serves the single-card engine's
    lists and the JAX engine's on its mesh; ``apply_delta`` equals an
    engine built on the patched model; the two-stage path (a replicated
    retriever per rank) equals its single-card twin."""
    k, out, (_, jeng) = world
    for r in range(k):
        got = out[r][len(CASES) + 2]
        for (ids, sc), (pids, psc), jres in zip(got["mesh"], got["plain"],
                                                jeng):
            assert_topk_tie_aware(ids, sc, pids, psc)
            assert_topk_tie_aware(ids, sc, np.asarray(jres[0]),
                                  np.asarray(jres[1]))
        for (ids, sc), (fids, fsc) in zip(got["delta"], got["fresh"]):
            np.testing.assert_array_equal(ids, fids)
            np.testing.assert_array_equal(sc, fsc)
        two = out[r][len(CASES) + 3]
        for (ids, sc), (pids, psc) in zip(two["mesh"], two["plain"]):
            np.testing.assert_array_equal(ids, pids)
            np.testing.assert_array_equal(sc, psc)
