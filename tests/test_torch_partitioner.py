"""The port's rank grid, rules table, placement and collectives against the
JAX package's ``Partitioner`` on the virtual CPU devices.

The port lays ``torch.distributed`` ranks out as JAX lays devices out
(``make_data_model_mesh``), so rank r of the port holds what JAX's device r
holds: the grids at (4, 1), (2, 2) and (8, 1) are equal, every spec is, and
each rank's ``place`` slice is bit-equal to JAX's shard on that device.
The multi-rank checks run in one spawn of 4 gloo ranks
(``tests/_torch_mesh_ranks.py``, joined under a deadline).
"""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.parallel import distributed as jdist
from large_scale_recommendation_tpu.parallel import mesh as jmesh
from large_scale_recommendation_tpu.parallel import partitioner as jpart
from large_scale_recommendation_tpu_torch.parallel import distributed
from large_scale_recommendation_tpu_torch.parallel import mesh
from large_scale_recommendation_tpu_torch.parallel import partitioner

import _torch_mesh_ranks as ranks

X = np.arange(64, dtype=np.float32).reshape(16, 4)
LOGICAL = [("users", "rank"), ("items", "rank"), ("ratings",),
           ("queries",), ("rank",), (), ("users", None), (None, "rank")]


@pytest.mark.parametrize("n,m", [(4, 1), (4, 2), (8, 1)])
def test_grid_equals_jax_mesh(n, m):
    jgrid = jpart.make_data_model_mesh(n, model_parallel=m).devices
    grid = partitioner.make_data_model_mesh(devices=range(n),
                                            model_parallel=m)
    np.testing.assert_array_equal(
        grid, np.vectorize(lambda d: d.id)(jgrid))
    assert grid.shape == (n // m, m)


def test_rules_table_and_specs_equal_jax():
    assert partitioner.DEFAULT_RULES == jpart.DEFAULT_RULES
    assert (partitioner.DATA_AXIS, partitioner.MODEL_AXIS) == (
        jpart.DATA_AXIS, jpart.MODEL_AXIS)
    part = partitioner.Partitioner(device="cpu")
    for n, m in ((4, 1), (4, 2), (8, 1)):
        jp = jpart.Partitioner(num_devices=n, model_parallel=m)
        for logical in LOGICAL:
            assert part.spec(*logical) == tuple(jp.spec(*logical)), logical
    with pytest.raises(KeyError, match="unknown logical axis"):
        part.spec("heads")
    assert part.ring_backward() == ((0, 0),)
    assert mesh.ring_backward(4) == jmesh.ring_backward(4)
    assert mesh.block_sharding(part) == ("data",)
    assert mesh.replicated(part) == ()


def test_one_process_needs_no_group_and_refuses_more_devices():
    part = partitioner.Partitioner(device="cpu")
    assert (part.num_blocks, part.model_parallel, part.world_size) == (1, 1,
                                                                       1)
    t = torch.arange(6.0).reshape(3, 2)
    placed = part.place(t, "users", "rank")
    assert torch.equal(placed, t) and placed.data_ptr() != t.data_ptr()
    assert part.ring_shift(t)[0] is t
    assert part.gather(placed, "users", "rank") is placed
    with pytest.raises(ValueError, match="need 4 devices"):
        partitioner.Partitioner(num_devices=4, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        partitioner.make_data_model_mesh(devices=range(4), model_parallel=3)
    with pytest.raises(TypeError, match="Partitioner"):
        partitioner.as_partitioner(object())
    assert partitioner.as_partitioner(part) is part
    part.require_rank_divisible(8, "x")
    assert mesh.make_block_mesh(device="cpu").num_blocks == 1
    got = distributed.make_global_array(t, part, part.spec("users", "rank"))
    assert torch.equal(got, t)


@pytest.fixture(scope="module")
def world4():
    """One spawn of 4 gloo ranks: the partitioner op at m = 1 and 2."""
    return ranks.run_world(4, [dict(op="partitioner", m=1, X=X),
                               dict(op="partitioner", m=2, X=X)])


@pytest.mark.parametrize("job,m", [(0, 1), (1, 2)])
def test_ranks_hold_what_jax_devices_hold(world4, job, m):
    jp = jpart.Partitioner(num_devices=4, model_parallel=m)
    k = 4 // m
    for logical, key in ((("users", "rank"), "users_rank"),
                         (("ratings",), "ratings"), (("queries",),
                                                     "queries")):
        jarr = jp.shard(X, *logical)
        by_dev = {sh.device.id: np.asarray(sh.data)
                  for sh in jarr.addressable_shards}
        for r in range(4):
            np.testing.assert_array_equal(world4[r][job][key], by_dev[r])
    for r in range(4):
        out = world4[r][job]
        di, mi = divmod(r, m)
        assert (out["k"], out["m"]) == (k, m)
        np.testing.assert_array_equal(out["grid"],
                                      np.arange(4).reshape(k, m))
        assert out["data"] == (tuple(range(mi, 4, m)), di)
        assert out["model"] == (tuple(range(di * m, di * m + m)), mi)
        assert out["spec"] == ("data", "model")
        assert out["offset"] == (di * (16 // k), mi * (4 // m))
        np.testing.assert_array_equal(out["gather"], X)
        # the ring: position j receives j+1's tensor (f32 and bf16)
        nxt = float(((di + 1) % k) * m + mi)
        assert out["shift"] == (nxt, nxt)
        assert out["model_sum"] == float(sum(range(di * m, di * m + m)))
        np.testing.assert_array_equal(out["world_gather"], np.arange(4.0))


def test_distributed_config_from_env(monkeypatch):
    for name in ("LSR_COORDINATOR", "LSR_NUM_PROCESSES", "LSR_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.DistributedConfig.from_env() == \
        distributed.DistributedConfig()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "2345")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert distributed.DistributedConfig.from_env() == \
        distributed.DistributedConfig("127.0.0.1:2345", 4, 2)
    monkeypatch.setenv("LSR_COORDINATOR", "host:9")
    monkeypatch.setenv("LSR_NUM_PROCESSES", "8")
    monkeypatch.setenv("LSR_PROCESS_ID", "5")
    cfg = distributed.DistributedConfig.from_env()
    jcfg = jdist.DistributedConfig.from_env()
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id) == (
        jcfg.coordinator_address, jcfg.num_processes, jcfg.process_id)


def test_initialize_distributed_single_process_and_refusals(monkeypatch):
    assert distributed.initialize_distributed(
        distributed.DistributedConfig(), device="cpu") is False
    assert not torch.distributed.is_initialized()
    # a group on the card needs NCCL and a card: never a gloo group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize_distributed(
            distributed.DistributedConfig("127.0.0.1:1", 2, 0))
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_distributed(
            distributed.DistributedConfig(None, 2, 0), device="cpu")


def test_host_rating_shard_equals_jax():
    rng = np.random.default_rng(0)
    ru = rng.integers(-50, 50, 400)
    ri, rv = rng.integers(0, 30, 400), rng.random(400).astype(np.float32)
    parts = [distributed.host_rating_shard(ru, ri, rv, p, 3)
             for p in range(3)]
    for p, mine in enumerate(parts):
        for a, b in zip(mine, jdist.host_rating_shard(ru, ri, rv, p, 3)):
            np.testing.assert_array_equal(a, b)
    assert sum(len(a[0]) for a in parts) == 400
