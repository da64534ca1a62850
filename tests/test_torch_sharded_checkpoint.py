"""The port's ``ShardedCheckpointManager`` across grids and across packages.

- tables saved from 4 gloo ranks at data 2 × model 2 restore bit-equal
  onto model 1, 2 and 4 (re-sharded), f32 and bf16;
- the JAX package restores the port's files (one file per rank) on its
  own meshes, and the port restores the JAX package's (one file per
  process, several pieces each), bit-equal;
- a ``MeshDSGD`` fit of 3 sweeps whose last snapshot is deleted resumes
  bit-equal to the uninterrupted fit (4 ranks, data 2 × model 2); the JAX
  ``MeshDSGD`` resumes the port's snapshot and the port resumes JAX's,
  each ending within the f32 mesh bar of tests/test_torch_dsgd_mesh.py
  (one resumed sweep: 4 strata × 1e-5);
- the refusals: another fit path's snapshot, a directory of
  single-process snapshots, and a warning for a crashed save.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
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
from large_scale_recommendation_tpu.utils import checkpoint as jck
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)
from large_scale_recommendation_tpu_torch.utils import checkpoint as ck

import _torch_mesh_ranks as ranks

KW = dict(num_factors=8, lambda_=0.01, iterations=3, learning_rate=0.05,
          lr_schedule="constant", seed=0, minibatch_size=64, init_scale=0.3)
RESUMED_SWEEP_TOL = 4 * 1e-5


def _tables(dtype=np.float32):
    rng = np.random.default_rng(1)
    return (rng.normal(size=(32, 8)).astype(dtype),
            rng.normal(size=(24, 8)).astype(dtype))


def _ratings():
    return SyntheticMFGenerator(num_users=96, num_items=64, rank=4,
                                noise=0.1, seed=0).generate(6000)


def _drop(directory, step):
    for name in os.listdir(directory):
        if name.startswith(f"ckpt_{step}."):
            os.unlink(os.path.join(directory, name))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX writes its snapshots first; then one spawn of 4 ranks runs the
    save/restore jobs and the DSGD fits and resumes."""
    d = {n: str(tmp_path_factory.mktemp(n)) for n in (
        "f32", "bf16", "jax_tables", "fit", "jax_fit", "port_fit")}
    U, V = _tables()
    jp8 = JPartitioner(num_devices=8, model_parallel=2)
    jck.ShardedCheckpointManager(d["jax_tables"]).save(
        7, {"U": jp8.shard(jnp.asarray(U), "users", "rank"),
            "V": jp8.shard(jnp.asarray(V), "items", "rank")},
        {"kind": "mesh"})
    train = _ratings()
    ratings = tuple(np.asarray(a) for a in train.to_numpy()[:3])
    jfit = JMeshDSGD(JMeshConfig(**KW, kernel="xla"),
                     partitioner=JPartitioner(num_devices=4)).fit(
        train, checkpoint_manager=jck.ShardedCheckpointManager(
            d["jax_fit"], keep=10), checkpoint_every=1)
    _drop(d["jax_fit"], 3)
    Ub = torch.from_numpy(U).to(torch.bfloat16)
    Vb = torch.from_numpy(V).to(torch.bfloat16)
    fit = dict(op="dsgd", m=2, cfg=dict(KW, kernel="torch"),
               ratings=ratings, checkpoint_every=1)
    jobs = [
        dict(op="checkpoint_reshard", m=2, U=U, V=V, ckpt=d["f32"], step=5,
             load_m=(1, 2, 4)),
        dict(op="checkpoint_reshard", m=2, U=Ub, V=Vb, ckpt=d["bf16"],
             step=6, load_m=(1, 4)),
        dict(op="checkpoint_reshard", m=1, U=U, V=V,
             ckpt=str(tmp_path_factory.mktemp("unused")), step=1,
             restore_from=d["jax_tables"], load_m=(1, 2)),
        dict(fit, ckpt=d["fit"]),  # 3 + the uninterrupted run
        dict(op="drop_step", ckpt=d["fit"], step=3),
        dict(fit, ckpt=d["fit"], resume=True),
        dict(op="dsgd", cfg=dict(KW, kernel="torch"), ratings=ratings,
             ckpt=d["port_fit"], checkpoint_every=1),
        dict(op="drop_step", ckpt=d["port_fit"], step=3),
        dict(op="dsgd", cfg=dict(KW, kernel="torch"), ratings=ratings,
             ckpt=d["jax_fit"], checkpoint_every=1, resume=True),
    ]
    out = ranks.run_world(4, jobs)
    return dict(dirs=d, U=U, V=V, out=out, train=train, jfit=jfit)


@pytest.mark.parametrize("job,dtype,loads", [(0, "float32", (1, 2, 4)),
                                             (1, "bfloat16", (1, 4))])
def test_round_trip_reshards_across_model_sizes(world, job, dtype, loads):
    U, V = world["U"], world["V"]
    if dtype == "bfloat16":
        U = torch.from_numpy(U).to(torch.bfloat16).float().numpy()
        V = torch.from_numpy(V).to(torch.bfloat16).float().numpy()
    for r in range(4):
        got = world["out"][r][job]
        assert sorted(got) == list(loads)
        for m in loads:
            done, U2, V2, shape, dt = got[m]
            assert done == (5 if job == 0 else 6)
            assert dt == f"torch.{dtype}"
            assert shape == (32 // (4 // m), 8 // m)
            np.testing.assert_array_equal(U2, U)
            np.testing.assert_array_equal(V2, V)
    # one file per rank, the column offsets of the rank-sharded pieces
    names = sorted(os.listdir(world["dirs"]["f32"]))
    assert names == ["ckpt_5.manifest.json"] + [
        f"ckpt_5.shard{r}of4.npz" for r in range(4)]
    with np.load(os.path.join(world["dirs"]["f32"],
                              "ckpt_5.shard3of4.npz")) as z:
        assert z["U__starts"].tolist() == [16]
        assert z["U__cstarts"].tolist() == [4]


@pytest.mark.parametrize("n,m", [(4, 2), (8, 1), (2, 1)])
def test_jax_restores_the_port_files(world, n, m):
    jp = JPartitioner(num_devices=n, model_parallel=m)
    mgr = jck.ShardedCheckpointManager(world["dirs"]["f32"])
    for key, axes in (("U", ("users", "rank")), ("V", ("items", "rank"))):
        want = world[key]
        arr = mgr.restore_array(5, key, jp.sharding(*axes), want.shape,
                                want.dtype)
        np.testing.assert_array_equal(np.asarray(arr), want)
    U2, V2, done = jck.restore_segment_state_sharded(
        mgr, "mesh", np.zeros_like(world["U"]), np.zeros_like(world["V"]),
        partitioner=jp)
    assert done == 5
    np.testing.assert_array_equal(np.asarray(U2), world["U"])
    bmgr = jck.ShardedCheckpointManager(world["dirs"]["bf16"])
    Ub = bmgr.restore_array(6, "U", jp.sharding("users", "rank"), (32, 8),
                            jnp.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(Ub).astype(np.float32),
        torch.from_numpy(world["U"]).to(torch.bfloat16).float().numpy())


def test_port_restores_the_jax_files(world):
    for r in range(4):
        got = world["out"][r][2]
        for m in (1, 2):
            done, U2, V2, _, _ = got[m]
            assert done == 7
            np.testing.assert_array_equal(U2, world["U"])
            np.testing.assert_array_equal(V2, world["V"])
    one = Partitioner(device="cpu")
    mgr = ck.ShardedCheckpointManager(world["dirs"]["jax_tables"])
    U = mgr.restore_array(7, "U", one, (32, 8), torch.float32, "users",
                          "rank")
    np.testing.assert_array_equal(U.numpy(), world["U"])


def test_mesh_fit_resume_is_bit_equal(world):
    for r in range(4):
        full, resumed = world["out"][r][3], world["out"][r][5]
        for key in ("U_l", "V_l", "U", "V"):
            np.testing.assert_array_equal(resumed[key], full[key])
    assert ck.ShardedCheckpointManager(world["dirs"]["fit"]).steps() == [
        1, 2, 3]


def test_jax_resumes_the_port_fit(world):
    """JAX's MeshDSGD resumes the port's sweep-2 snapshot and runs sweep 3;
    the port's own uninterrupted run is the reference."""
    jm = JMeshDSGD(JMeshConfig(**KW, kernel="xla"),
                   partitioner=JPartitioner(num_devices=4)).fit(
        world["train"], checkpoint_manager=jck.ShardedCheckpointManager(
            world["dirs"]["port_fit"], keep=10), checkpoint_every=1,
        resume=True)
    port = world["out"][0][6]
    for a, b in ((jm.U, port["U"]), (jm.V, port["V"])):
        assert np.abs(np.asarray(a) - b).max() <= RESUMED_SWEEP_TOL


def test_port_resumes_the_jax_fit(world):
    port = world["out"][0][8]
    for a, b in ((port["U"], world["jfit"].U), (port["V"], world["jfit"].V)):
        assert np.abs(a - np.asarray(b)).max() <= RESUMED_SWEEP_TOL


def test_refusals(tmp_path):
    one = Partitioner(device="cpu")
    U, V = (torch.from_numpy(a) for a in _tables())
    mgr = ck.ShardedCheckpointManager(str(tmp_path / "a"))
    assert ck.restore_segment_state_sharded(mgr, "k", U, V, one)[2] == 0
    mgr.save(2, {"U": one.local_shard(U, "users", "rank"),
                 "V": one.local_shard(V, "items", "rank")}, {"kind": "k"})
    with pytest.raises(ValueError, match="does not match this fit path"):
        ck.restore_segment_state_sharded(mgr, "other", U, V, one)
    with pytest.raises(ValueError, match="shape"):
        ck.restore_segment_state_sharded(mgr, "k", U[:8], V, one)
    # a manifest whose shard is missing: warned, the older step resumes
    mgr.save(4, {"U": U, "V": V}, {"kind": "k"})
    os.unlink(os.path.join(mgr.directory, "ckpt_4.shard0of1.npz"))
    with pytest.warns(RuntimeWarning, match="incomplete"):
        U2, _, done = ck.restore_segment_state_sharded(mgr, "k", U, V, one)
    assert done == 2 and torch.equal(U2, U)
    legacy = ck.CheckpointManager(str(tmp_path / "b"))
    legacy.save(1, {"U": U, "V": V}, {"kind": "k"})
    with pytest.raises(ValueError, match="single-process"):
        ck.restore_segment_state_sharded(
            ck.ShardedCheckpointManager(legacy.directory), "k", U, V, one)
    # retention keeps the newest complete steps
    keep = ck.ShardedCheckpointManager(str(tmp_path / "c"), keep=2)
    for s in (1, 2, 3):
        keep.save(s, {"U": U}, {"kind": "k"})
    assert keep.steps() == [2, 3]
