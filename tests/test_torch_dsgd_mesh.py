"""The port's ``MeshDSGD`` on 4 gloo ranks against the JAX package's
``MeshDSGD`` on ``Partitioner(num_devices=4)`` (virtual CPU devices).

Same ratings, same blocking (the port's host blocking is bit-equal to
JAX's), JAX's initial tables carried across; both fit 3 sweeps with a
sharded snapshot per sweep, and each sweep's tables are read back from the
snapshots (the port's reader on both packages' files). Bars:

- f32, ``kernel="torch"`` against JAX ``"xla"``: max-abs 1e-5 per stratum
  swept (4 strata a sweep: 4e-5 after sweep 1, 8e-5 after 2, 1.2e-4 after
  3; f32 dot order differs between the frameworks), holdout RMSE per
  sweep within 1e-4;
- bf16 (the same routes, rounded once per segment on both sides): every
  element within one bf16 ulp, RMSE within 1e-3;
- ``kernel="cuda"`` (on the CPU ``block_sweep`` runs each rank's
  ``[k, 1, b]`` plan through the step pair's plain versions, rounded once
  per visit in bf16) against JAX ``"pallas"`` in interpret mode: the
  same bars;
- the port's mesh at world 4 against the port's single-device ``DSGD`` at
  ``num_blocks=4`` (the JAX package's own mesh-vs-single bar,
  tests/test_dsgd_mesh.py: rtol 2e-3 / atol 2e-4), on ``fit`` and on
  ``fit_device``.
"""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JConfig
from large_scale_recommendation_tpu.ops import sgd as jsgd
from large_scale_recommendation_tpu.parallel.dsgd_mesh import (
    MeshDSGD as JMeshDSGD,
)
from large_scale_recommendation_tpu.parallel.dsgd_mesh import (
    MeshDSGDConfig as JMeshConfig,
)
from large_scale_recommendation_tpu.parallel.dsgd_mesh import (
    device_major_local_strata as j_strata,
)
from large_scale_recommendation_tpu.parallel.partitioner import (
    Partitioner as JPartitioner,
)
from large_scale_recommendation_tpu.utils.checkpoint import (
    ShardedCheckpointManager as JSharded,
)
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.parallel.dsgd_mesh import (
    MeshDSGD,
    MeshDSGDConfig,
    build_mesh_dsgd_step,
    device_major_local_strata,
)
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    ShardedCheckpointManager,
)

import _torch_mesh_ranks as ranks

NU, NI, K, SWEEPS = 96, 64, 4, 3
KW = dict(num_factors=8, lambda_=0.01, iterations=SWEEPS, learning_rate=0.05,
          lr_schedule="constant", seed=0, minibatch_size=64, init_scale=0.3)
F32_PER_STRATUM = 1e-5
RMSE_F32, RMSE_BF16 = 1e-4, 1e-3
# (port route, JAX route, dtype): the parity cases
CASES = {"torch_f32": ("torch", "xla", "float32"),
         "torch_bf16": ("torch", "xla", "bfloat16"),
         "cuda_f32": ("cuda", "pallas", "float32"),
         "cuda_bf16": ("cuda", "pallas", "bfloat16")}


def bf16_ulp(x):
    """One bf16 ulp at |x| (2^(e−7))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _data():
    gen = SyntheticMFGenerator(num_users=NU, num_items=NI, rank=4,
                               noise=0.1, seed=0)
    return gen.generate(6000), gen.generate(600)


def _snapshots(directory, shape_u, shape_v):
    """Each sweep's whole tables from a sharded checkpoint directory, read
    with the port's manager on one rank."""
    mgr = ShardedCheckpointManager(directory, keep=10)
    one = Partitioner(device="cpu")
    return [tuple(mgr.restore_array(s, key, one, shape, torch.float32,
                                    axes, "rank").numpy()
                  for key, shape, axes in (("U", shape_u, "users"),
                                           ("V", shape_v, "items")))
            for s in mgr.steps()]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    train, test = _data()
    problem = jblk.block_problem(train, num_blocks=K, seed=0,
                                 minibatch_multiple=KW["minibatch_size"])
    U0, V0 = (np.asarray(a) for a in JDSGD(JConfig(
        num_factors=8, seed=0, init_scale=0.3))._init_factors(problem))
    ratings = tuple(np.asarray(a) for a in train.to_numpy()[:3])
    jobs, jax_dirs, port_dirs = [], {}, {}
    jpart = JPartitioner(num_devices=K)
    for name, (route, jroute, dtype) in CASES.items():
        jd = str(tmp_path_factory.mktemp(f"jax_{name}"))
        pd = str(tmp_path_factory.mktemp(f"port_{name}"))
        JMeshDSGD(JMeshConfig(**KW, kernel=jroute, factor_dtype=dtype),
                  partitioner=jpart).fit(
            train, checkpoint_manager=JSharded(jd, keep=10),
            checkpoint_every=1)
        jobs.append(dict(op="dsgd", cfg=dict(KW, kernel=route,
                                             factor_dtype=dtype),
                         ratings=ratings, init=(U0, V0), ckpt=pd,
                         checkpoint_every=1, recommend=train.users[:30]))
        jax_dirs[name], port_dirs[name] = jd, pd
    # fit_device at world 4, torch route, the port's own init
    u, i, r = _dense()
    jobs.append(dict(op="dsgd", cfg=dict(KW, kernel="torch"),
                     ratings=(u, i, r), device_path=True, num_users=NU,
                     num_items=NI))
    out = ranks.run_world(K, jobs)
    return dict(train=train, test=test, problem=problem, U0=U0, V0=V0,
                jax_dirs=jax_dirs, port_dirs=port_dirs, out=out)


def _dense():
    rng = np.random.default_rng(4)
    n = 5000
    return (rng.integers(0, NU, n).astype(np.int32),
            rng.integers(0, NI, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32))


def _rmse(problem, test, U, V):
    return convert.model_from_jax(U, V, problem.users, problem.items,
                                  device="cpu").rmse(
        Ratings.from_arrays(*test.to_numpy()))


def test_device_major_local_strata_bit_equal():
    train, _ = _data()
    for k in (2, 4):
        jp = jblk.block_problem(train, num_blocks=k, seed=0,
                                minibatch_multiple=64, minibatch_sort="item")
        pp = blocking.block_problem(Ratings.from_arrays(*train.to_numpy()),
                                    num_blocks=k, seed=0,
                                    minibatch_multiple=64,
                                    minibatch_sort="item")
        for a, b in zip(device_major_local_strata(pp), j_strata(jp)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_matches_jax_mesh_per_sweep(fits, name):
    route, _, dtype = CASES[name]
    shape_u, shape_v = fits["U0"].shape, fits["V0"].shape
    port = _snapshots(fits["port_dirs"][name], shape_u, shape_v)
    ref = _snapshots(fits["jax_dirs"][name], shape_u, shape_v)
    assert len(port) == len(ref) == SWEEPS
    for s, ((U, V), (JU, JV)) in enumerate(zip(port, ref), start=1):
        if dtype == "float32":
            tol = F32_PER_STRATUM * K * s
            for a, b in ((U, JU), (V, JV)):
                assert np.abs(a - b).max() <= tol, (s, np.abs(a - b).max())
            bar = RMSE_F32
        else:
            for a, b in ((U, JU), (V, JV)):
                assert (np.abs(a - b) <= bf16_ulp(b)).all(), s
            bar = RMSE_BF16
        p, j = (_rmse(fits["problem"], fits["test"], *t)
                for t in ((U, V), (JU, JV)))
        assert abs(p - j) <= bar, (s, p, j)
    # the ranks' fitted shards are the last snapshot's slices
    job = list(CASES).index(name)
    for r, res in enumerate(fits["out"]):
        got = res[job]
        assert got["dtype"] == dtype
        rpb = shape_u[0] // K
        np.testing.assert_array_equal(got["U_l"], port[-1][0][r * rpb:
                                                            (r + 1) * rpb])
        np.testing.assert_array_equal(got["U"], port[-1][0])
        np.testing.assert_array_equal(got["V"], port[-1][1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_model_serves_its_gathered_tables(fits, name):
    """``ShardedMFModel.recommend`` at world 4 (each rank's V shard the
    catalog, U gathered): every rank's lists equal the plain ``recommend``
    of the gathered tables (ids exact, scores within 1e-6), and a second
    call reuses the cached catalog and U with the same answer."""
    job = list(CASES).index(name)
    res = fits["out"][0][job]
    model = convert.model_from_jax(res["U"], res["V"], fits["problem"].users,
                                   fits["problem"].items, device="cpu")
    ids, scores = model.recommend(fits["train"].users[:30], k=5)
    for r, out in enumerate(fits["out"]):
        got_ids, got_scores = out[job]["recs"]
        np.testing.assert_array_equal(got_ids, ids, err_msg=f"rank {r}")
        np.testing.assert_allclose(got_scores, scores, rtol=1e-6, atol=1e-6)
        assert out[job]["recs_again_equal"] and out[job]["cache_kept"]


def test_mesh_learns(fits):
    U, V = _snapshots(fits["port_dirs"]["torch_f32"], fits["U0"].shape,
                      fits["V0"].shape)[-1]
    before = _rmse(fits["problem"], fits["test"], fits["U0"], fits["V0"])
    assert _rmse(fits["problem"], fits["test"], U, V) < 0.95 * before


def test_mesh_equals_single_device_dsgd(fits):
    """The port's own consistency: the ring walk is the stratum walk."""
    solver = DSGD(DSGDConfig(**KW), device="cpu")
    solver._init_factors = lambda _p: convert.factors_from_jax(
        fits["U0"], fits["V0"], device="cpu")
    single = solver.fit(Ratings.from_arrays(*fits["train"].to_numpy()),
                        num_blocks=K)
    got = fits["out"][0][list(CASES).index("torch_f32")]
    np.testing.assert_allclose(got["U"], single.U.numpy(), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["V"], single.V.numpy(), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_array_equal(got["user_ids"], single.users.ids)


def test_fit_device_mesh_equals_single_device_fit_device(fits):
    u, i, r = _dense()
    single = DSGD(DSGDConfig(**KW), device="cpu").fit_device(
        u, i, r, NU, NI, num_blocks=K)
    got = fits["out"][0][len(CASES)]
    np.testing.assert_allclose(got["U"], single.U.numpy(), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["V"], single.V.numpy(), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_array_equal(got["user_ids"], single.users.ids)


def test_world_one_is_the_single_device_fit():
    """At world 1 the mesh runs the single-device DSGD's sweeps exactly
    (both routes; bf16 too), and its model serves like one."""
    train, test = _data()
    tr = Ratings.from_arrays(*train.to_numpy())
    part = Partitioner(device="cpu")
    for dtype in ("float32", "bfloat16"):
        kw = dict(KW, factor_dtype=dtype)
        single = DSGD(DSGDConfig(**kw), device="cpu").fit(tr, num_blocks=1)
        for route in ("torch", "cuda"):
            mesh = MeshDSGD(MeshDSGDConfig(**kw, kernel=route),
                            partitioner=part).fit(tr)
            if route == "torch" or dtype == "float32":
                assert torch.equal(mesh.U, single.U), (dtype, route)
                assert torch.equal(mesh.V, single.V), (dtype, route)
            ids, scores = mesh.recommend(train.users[:20], k=5)
            ids1, scores1 = single.recommend(train.users[:20], k=5)
            if route == "torch" or dtype == "float32":
                np.testing.assert_array_equal(ids, ids1)
                np.testing.assert_array_equal(scores, scores1)
            assert abs(mesh.rmse(Ratings.from_arrays(*test.to_numpy()))
                       - single.rmse(Ratings.from_arrays(*test.to_numpy()))
                       ) < 1e-2


def test_route_contracts():
    part = Partitioner(device="cpu")
    upd = MeshDSGD(MeshDSGDConfig(**KW), partitioner=part).updater
    with pytest.raises(ValueError, match="unknown kernel"):
        build_mesh_dsgd_step(part, upd, 64, 1, kernel="xla")
    with pytest.raises(ValueError, match="RegularizedSGDUpdater"):
        build_mesh_dsgd_step(part, upd, 64, 1, collision="sum",
                             with_inv=True, kernel="cuda")
    build_mesh_dsgd_step(part, upd, 64, 1, collision="sum", kernel="torch")
    train, _ = _data()
    with pytest.raises(ValueError, match="factor_dtype"):
        MeshDSGD(MeshDSGDConfig(**dict(KW, factor_dtype="float16")),
                 partitioner=part).fit(Ratings.from_arrays(
                     *train.to_numpy()))
    with pytest.raises(ValueError, match="empty"):
        MeshDSGD(partitioner=part).fit(Ratings.from_arrays(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float32)))
    assert sgd_ops.dsgd_collective_bytes_per_sweep(1000, 8, 1) == 0
    assert sgd_ops.dsgd_collective_bytes_per_sweep(1000, 8, 4) == 6000
    assert sgd_ops.dsgd_bytes_per_sweep(1000, 8, model_size=2) == \
        1000 * (4 * 4 * 4 + 16)
    with pytest.raises(ValueError, match="rank-sharded"):
        sgd_ops.dsgd_bytes_per_sweep(1000, 8, kernel="cuda", model_size=2)
    with pytest.raises(ValueError, match="divide"):
        sgd_ops.dsgd_bytes_per_sweep(1000, 8, model_size=3)
    for m in (1, 2, 4):
        assert sgd_ops.dsgd_collective_bytes_per_sweep(1000, 8, m) == \
            jsgd.dsgd_collective_bytes_per_sweep(1000, 8, m)
        assert sgd_ops.dsgd_bytes_per_sweep(1000, 8, model_size=m) == \
            jsgd.dsgd_bytes_per_sweep(1000, 8, model_size=m)


def test_jax_tables_become_this_ranks_shards(fits):
    """``convert.shards_from_jax`` / ``sharded_model_from_jax``: the JAX
    package's whole tables (f32 and bf16) as one rank's shards, serving as
    the JAX model does."""
    import ml_dtypes

    part = Partitioner(device="cpu")
    U0, V0 = fits["U0"], fits["V0"]
    U, V = convert.shards_from_jax(U0, V0, part)
    np.testing.assert_array_equal(U.numpy(), U0)
    Ub, _ = convert.shards_from_jax(U0.astype(ml_dtypes.bfloat16), V0, part)
    assert Ub.dtype == torch.bfloat16
    p = fits["problem"]
    model = convert.sharded_model_from_jax(U0, V0, p.users, p.items, part)
    users = fits["train"].to_numpy()[0][:16]
    ids, scores = model.recommend(users, k=5)
    ref = convert.model_from_jax(U0, V0, p.users, p.items, device="cpu")
    ids1, scores1 = ref.recommend(users, k=5)
    np.testing.assert_array_equal(ids, ids1)
    np.testing.assert_array_equal(scores, scores1)
    np.testing.assert_array_equal(model.predict(users, users),
                                  ref.predict(users, users))


# -- global_device_blocked: each rank blocks from only its own ratings -----

GB = dict(num_users=NU, num_items=NI, mb=64, rank=8, sweeps=2)


def _global_inputs(n=4000, pad=96):
    rng = np.random.default_rng(11)
    u = rng.integers(0, NU, n)
    i = rng.integers(0, NI, n)
    r = rng.normal(size=n).astype(np.float32)
    w = np.ones(n, np.float32)
    w[rng.choice(n, pad, replace=False)] = 0.0  # weight-0 padding entries
    return u, i, r, w


@pytest.fixture(scope="module")
def global_blocked():
    u, i, r, w = _global_inputs()
    job = dict(op="global_blocking", u=u, i=i, r=r, w=w, **GB)
    return ranks.run_world(4, [dict(job, m=1), dict(job, m=2),
                               dict(job, ragged=True)])


@pytest.mark.parametrize("job,m", [(0, 1), (1, 2)])
def test_global_device_blocked_equals_the_whole_blocking(global_blocked,
                                                         job, m):
    """Rank by rank, bit-equal to ``device_block_problem`` of the ratings
    concatenated (the same seed), cut to the rank's cells; its init the
    keyed rows; trained on the mesh, within the mesh-vs-single bar of the
    single-device DSGD on that problem."""
    from large_scale_recommendation_tpu_torch.data import device_blocking

    u, i, r, w = _global_inputs()
    k = 4 // m
    p = device_blocking.device_block_problem(
        u, i, r, NU, NI, num_blocks=k, minibatch_multiple=GB["mb"], seed=0,
        weights=w, device="cpu")
    U0, V0 = device_blocking.init_factors_device(p, GB["rank"], 0.3)
    rpb_u, rpb_v = p.rows_per_block_u, p.rows_per_block_v
    for rk, res in enumerate(global_blocked):
        got = res[job]
        di, mi = divmod(rk, m)
        want = {"ru": p.su[:, di] % rpb_u, "ri": p.si[:, di] % rpb_v,
                "rv": p.sv[:, di], "rw": p.sw[:, di], "icu": p.icu[:, di],
                "icv": p.icv[:, di],
                "omega_u": p.omega_u[di * rpb_u:(di + 1) * rpb_u],
                "omega_v": p.omega_v[di * rpb_v:(di + 1) * rpb_v]}
        for key, t in want.items():
            np.testing.assert_array_equal(got[key], t.float().numpy(), key)
        c = slice(mi * GB["rank"] // m, (mi + 1) * GB["rank"] // m)
        np.testing.assert_array_equal(
            got["U"], U0[di * rpb_u:(di + 1) * rpb_u, c].numpy())
        np.testing.assert_array_equal(got["row_of_user"],
                                      p.row_of_user.numpy())
    cfg = DSGDConfig(num_factors=GB["rank"], lambda_=0.01,
                     learning_rate=0.05, lr_schedule="constant",
                     iterations=GB["sweeps"], minibatch_size=GB["mb"])
    solver = DSGD(cfg, device="cpu")
    solver._init_factors_device = lambda _p: (U0, V0)
    single = solver._fit_problem(p)
    got = global_blocked[0][job]
    np.testing.assert_allclose(got["U_trained"], single.U.numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got["V_trained"], single.V.numpy(),
                               rtol=2e-3, atol=2e-4)


def test_global_device_blocked_refuses_ragged_shards(global_blocked):
    for res in global_blocked:
        assert "equal-length" in res[2]["error"]
