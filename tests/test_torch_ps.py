"""The port's parameter server (``ps.core``, ``ps.server``, ``ps.transform``,
``ps.mf``) and its support pieces against the JAX package's, on the CPU,
from the same seeded numpy inputs.

Bars:
- the three rating generators, ``pad_axis0_pow2``, ``SGDUpdater.delta_np``
  and ``HostFactorTable`` are numpy in both packages: bit-equal;
- PS offline MF on the deterministic topologies (W = 1 / P = 1 at pull
  windows 1 and 2, W = 1 / P = 3 at pull window 1): final user and item
  factors within rtol 1e-4 / atol 1e-5 (``online_train`` sums in another
  order than XLA), holdout RMSE within 1e-5. Both packages' PS modules
  build their initializers through one patched name, a
  ``FunctionFactorInitializer`` over one seeded numpy table;
- several workers are asynchronous in both packages (answer order
  follows thread timing), so those runs are held to the JAX tests' own
  quality bars (``tests/test_ps.py``), never to one interleaving, on the
  JAX tests' inputs: the port's PS modules then initialize rows as the
  JAX package's ``PseudoRandomFactorInitializer`` does (``jax_rows``).

Every run bounds its wait: ``iteration_wait_time`` of 30 s (an idle window:
a wedged topology raises ``TimeoutError``), joins with limits.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core import generators as jgen
from large_scale_recommendation_tpu.core.initializers import (
    FunctionFactorInitializer as JFunctionInit,
)
from large_scale_recommendation_tpu.core.initializers import (
    PseudoRandomFactorInitializer as JPseudoRandomInit,
)
from large_scale_recommendation_tpu.core.updaters import (
    SGDUpdater as JSGDUpdater,
)
from large_scale_recommendation_tpu.core.updaters import (
    inverse_sqrt_lr as jinverse_sqrt,
)
from large_scale_recommendation_tpu.data.tables import (
    HostFactorTable as JHostTable,
)
from large_scale_recommendation_tpu.ps import mf as jmf
from large_scale_recommendation_tpu.ps import transform as jtransform
from large_scale_recommendation_tpu.utils.shapes import (
    pad_axis0_pow2 as jpad_axis0_pow2,
)
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core import generators as pgen
from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.core.updaters import (
    SGDUpdater,
    inverse_sqrt_lr,
)
from large_scale_recommendation_tpu_torch.data.tables import HostFactorTable
from large_scale_recommendation_tpu_torch.ps import mf as pmf
from large_scale_recommendation_tpu_torch.ps import transform as ptransform
from large_scale_recommendation_tpu_torch.ps.core import PullAnswer
from large_scale_recommendation_tpu_torch.ps.mf import (
    PSOfflineMF,
    PSOfflineMFConfig,
)
from large_scale_recommendation_tpu_torch.ps.server import (
    ShardedParameterStore,
    SimplePSLogic,
)
from large_scale_recommendation_tpu_torch.ps.transform import (
    PSTopology,
    ps_transform,
)
from large_scale_recommendation_tpu_torch.utils.shapes import pad_axis0_pow2

WAIT = 30.0  # the topology's idle window in every run here
TOL = dict(rtol=1e-4, atol=1e-5)
_INIT = np.random.default_rng(7).uniform(
    0.0, 0.3, (4096, 8)).astype(np.float32)


def table_inits(rank):
    """One seeded numpy table behind both packages' initializers."""
    table = _INIT[:, :rank]

    def jinit(r, scale=1.0):
        return JFunctionInit(r, lambda ids: jnp.asarray(
            table[np.asarray(ids)]))

    def pinit(r, scale=1.0):
        return FunctionFactorInitializer(r, lambda ids: torch.from_numpy(
            table[np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                             else ids)]))

    return jinit, pinit


def patch_ps(monkeypatch, jmods, pmods, rank):
    """Both packages' PS modules build the same initial rows, and their
    topologies run with a bounded idle window."""
    jinit, pinit = table_inits(rank)
    for m in jmods:
        monkeypatch.setattr(m, "PseudoRandomFactorInitializer", jinit)
        monkeypatch.setattr(m, "ps_transform", functools.partial(
            jtransform.ps_transform, iteration_wait_time=WAIT))
    for m in pmods:
        monkeypatch.setattr(m, "PseudoRandomFactorInitializer", pinit)
        monkeypatch.setattr(m, "ps_transform", functools.partial(
            ptransform.ps_transform, iteration_wait_time=WAIT))


def jax_rows(monkeypatch, pmods):
    """The port's PS modules initialize rows as the JAX package's
    ``PseudoRandomFactorInitializer`` does (the inputs the JAX tests'
    quality bars were set on; the port's keyed rows are other samples of
    the same distribution), with a bounded idle window."""

    def pinit(r, scale=1.0):
        jinit = JPseudoRandomInit(r, scale=scale)
        return FunctionFactorInitializer(r, lambda ids: torch.from_numpy(
            np.array(jinit(jnp.asarray(np.asarray(ids.cpu()))))))

    for m in pmods:
        monkeypatch.setattr(m, "PseudoRandomFactorInitializer", pinit)
        monkeypatch.setattr(m, "ps_transform", functools.partial(
            ptransform.ps_transform, iteration_wait_time=WAIT))


def make_store(rank=4, ps=2, emit=True):
    init = PseudoRandomFactorInitializer(rank, scale=1.0)
    return ShardedParameterStore(
        lambda p: SimplePSLogic(init, emit_updates=emit), ps)


def planted(n=8000, seed=0, skew=None, test=1500):
    gen = SyntheticMFGenerator(num_users=60, num_items=40, rank=4,
                               noise=0.05, seed=seed, skew_lam=skew)
    return gen.generate(n), gen.generate(test)


def jratings(r):
    from large_scale_recommendation_tpu.core.types import Ratings as JR

    return JR.from_arrays(*r.to_numpy())


def assert_dicts_close(a, b, **tol):
    assert sorted(a) == sorted(b)
    keys = sorted(a)
    np.testing.assert_allclose(np.stack([a[k] for k in keys]),
                               np.stack([np.asarray(b[k]) for k in keys]),
                               **tol)


# -- support pieces -----------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("UniformRatingGenerator", dict(num_users=50, num_items=30, seed=3)),
    ("ExponentialRatingGenerator", dict(num_users=50, num_items=30,
                                        lam=2.0, seed=4)),
])
def test_rating_generators_bit_equal(name, args):
    a, b = getattr(pgen, name)(**args), getattr(jgen, name)(**args)
    for n in (1, 257, 4000):
        ga, gb = a.generate(n).to_numpy(), b.generate(n).to_numpy()
        for x, y in zip(ga, gb):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_discrete_exponential_generator_bit_equal():
    a = pgen.DiscreteExponentialGenerator(lam=1.5, n=1000, seed=9)
    b = jgen.DiscreteExponentialGenerator(lam=1.5, n=1000, seed=9)
    for size in (1, 10, 5000):
        x = a.gen(size)
        np.testing.assert_array_equal(x, b.gen(size))
        assert x.min() >= 0 and x.max() < 1000


@pytest.mark.parametrize("n,floor", [(0, 8), (5, 8), (8, 8), (9, 8),
                                     (300, 64)])
def test_pad_axis0_pow2_matches_jax(n, floor):
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    got, want = pad_axis0_pow2(a, floor), jpad_axis0_pow2(a, floor)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("schedule", ["constant", "inverse_sqrt"])
def test_delta_np_bit_equal_to_jax_and_twin_of_delta(schedule):
    rng = np.random.default_rng(11)
    p, j = SGDUpdater(learning_rate=0.07), JSGDUpdater(learning_rate=0.07)
    if schedule == "inverse_sqrt":
        p = SGDUpdater(learning_rate=0.07, schedule=inverse_sqrt_lr)
        j = JSGDUpdater(learning_rate=0.07, schedule=jinverse_sqrt)
    for t in (1, 2, 7):
        u = rng.normal(size=8).astype(np.float32)
        v = rng.normal(size=8).astype(np.float32)
        r = float(rng.normal())
        du, dv = p.delta_np(r, u, v, t=t)
        jdu, jdv = j.delta_np(r, u, v, t=t)
        assert du.dtype == np.float32 and dv.dtype == np.float32
        np.testing.assert_array_equal(du, jdu)
        np.testing.assert_array_equal(dv, jdv)
        # the tensor rule on the same rating, within one f32 rounding
        tu, tv = p.delta(torch.tensor([r], dtype=torch.float32),
                         torch.from_numpy(u)[None], torch.from_numpy(v)[None],
                         t=t)
        np.testing.assert_allclose(du, tu[0].numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(dv, tv[0].numpy(), rtol=1e-5, atol=1e-7)


def test_host_factor_table_matches_jax():
    jinit, pinit = table_inits(4)
    p, j = HostFactorTable(pinit(4), capacity=8), JHostTable(jinit(4),
                                                             capacity=8)
    rng = np.random.default_rng(2)
    for _ in range(5):
        ids = rng.integers(0, 300, 23)
        np.testing.assert_array_equal(p.ensure(ids), j.ensure(ids))
        assert p.capacity == j.capacity
        np.testing.assert_array_equal(p.array, np.asarray(j.array))
    assert isinstance(p.array, np.ndarray)
    d = p.as_dict()
    k = next(iter(d))
    d[k][:] = 99.0  # a copy: the live table is untouched
    assert not (p.lookup(np.asarray([k])) == 99.0).any()
    jd = j.as_dict()
    assert_dicts_close(p.as_dict(), jd, rtol=0, atol=0)


# -- server logic -------------------------------------------------------------


def test_pull_initializes_per_id():
    init = PseudoRandomFactorInitializer(4, scale=1.0)
    logic = SimplePSLogic(init)
    v = logic.on_pull(np.array([7, 9]))
    np.testing.assert_array_equal(v, init(np.asarray([7, 9])).numpy())


def test_push_adds_delta_accumulates_duplicates_and_emits():
    logic = SimplePSLogic(PseudoRandomFactorInitializer(3, scale=0.0))
    logic.on_pull(np.array([5]))
    outs = []
    logic.on_push(np.array([5, 5]), np.ones((2, 3), np.float32), outs)
    assert [o[0] for o in outs] == [5, 5]
    np.testing.assert_array_equal(logic.snapshot()[5], np.full(3, 2.0))


def test_custom_update_fn():
    logic = SimplePSLogic(PseudoRandomFactorInitializer(2, scale=0.0),
                          update=lambda old, delta: delta, device="cuda")
    logic.on_pull(np.array([1]))
    outs = []
    logic.on_push(np.array([1]), np.full((1, 2), 9.0, np.float32), outs)
    np.testing.assert_array_equal(outs[0][1], np.full(2, 9.0))


# -- topology -----------------------------------------------------------------


def test_echo_roundtrip_and_output_split():
    class Echo:
        def on_recv(self, x, ps):
            ps.pull(np.array([x]))

        def on_pull_answer(self, a: PullAnswer, ps):
            ps.output((int(a.ids[0]), a.values[0].copy()))
            ps.push(a.ids, np.ones_like(a.values))

        def close(self, ps):
            ps.output("closed")

    wouts, psouts = ps_transform([[1, 2], [3]], [Echo(), Echo()],
                                 make_store(), pull_limit=1,
                                 iteration_wait_time=WAIT)
    assert sorted(x[0] for w in wouts for x in w if x != "closed") == [1, 2, 3]
    assert all(w[-1] == "closed" for w in wouts)
    assert sorted(x[0] for x in psouts) == [1, 2, 3]


def test_shard_routing():
    store = make_store(ps=3)
    ids = np.arange(-7, 20)
    np.testing.assert_array_equal(store.shard_of(ids), np.abs(ids) % 3)


def test_pull_limit_bounds_in_flight():
    seen_max = [0]
    lock = threading.Lock()

    class SlowLogic(SimplePSLogic):
        def __init__(self, topo_ref):
            super().__init__(PseudoRandomFactorInitializer(2, scale=0.0))
            self._topo_ref = topo_ref

        def on_pull(self, ids):
            client = self._topo_ref[0]._clients[0]
            with lock:
                seen_max[0] = max(seen_max[0], client._in_flight)
            return super().on_pull(ids)

    class Puller:
        def on_recv(self, x, ps):
            for j in range(10):
                ps.pull(np.array([j]))

        def on_pull_answer(self, a, ps):
            pass

        def close(self, ps):
            pass

    topo_ref = []
    store = ShardedParameterStore(lambda p: SlowLogic(topo_ref), 1)
    topo = PSTopology([Puller()], store, pull_limit=3)
    topo_ref.append(topo)
    topo.run([[0]], timeout=WAIT)
    assert 1 <= seen_max[0] <= 3


def test_cross_shard_pull_reassembled():
    answers = []

    class Logic:
        def on_recv(self, x, ps):
            ps.pull(np.array([4, 0, 5, 1, 2, 3]))  # spans all 3 shards

        def on_pull_answer(self, a: PullAnswer, ps):
            answers.append(a)

        def close(self, ps):
            pass

    store = make_store(rank=2, ps=3)
    topo = PSTopology([Logic()], store, pull_limit=1)
    topo.run([[0]], timeout=WAIT)
    assert len(answers) == 1
    np.testing.assert_array_equal(answers[0].ids, [4, 0, 5, 1, 2, 3])
    expect = np.concatenate([store.shards[i % 3].on_pull(np.array([i]))
                             for i in (4, 0, 5, 1, 2, 3)])
    np.testing.assert_array_equal(answers[0].values, expect)
    assert topo._clients[0]._in_flight == 0
    assert not topo._clients[0]._assembling


def test_control_ordered_after_prior_traffic_same_worker():
    events: list = []

    class RecordingShard:
        def on_pull(self, ids):
            events.append(("pull", ids.tolist()))
            return np.zeros((len(ids), 2), np.float32)

        def on_push(self, ids, deltas, outputs, worker_id=-1):
            events.append(("push", ids.tolist()))

        def on_control(self, worker_id, payload, outputs):
            events.append(("control", payload))

        def snapshot(self):
            return {}

    class Worker:
        def on_recv(self, data, ps):
            ps.pull(np.asarray([0], np.int64))
            ps.push(np.asarray([0], np.int64), np.ones((1, 2), np.float32))
            ps.control(0, "marker")

        def on_pull_answer(self, answer, ps):
            pass

        def close(self, ps):
            pass

    store = ShardedParameterStore(lambda p: RecordingShard(), 1)
    ps_transform([[1]], [Worker()], store, pull_limit=None,
                 iteration_wait_time=WAIT)
    kinds = [k for k, _ in events]
    assert kinds.index("control") > kinds.index("pull")
    assert kinds.index("control") > kinds.index("push")


def test_shard_exception_fails_the_run_promptly():
    class BadShard(SimplePSLogic):
        def on_pull(self, ids):
            raise RuntimeError("shard boom")

    class Puller:
        def on_recv(self, x, ps):
            ps.pull(np.array([int(x)]))

        def on_pull_answer(self, a, ps):
            pass

        def close(self, ps):
            pass

    store = ShardedParameterStore(
        lambda p: BadShard(PseudoRandomFactorInitializer(2, scale=0.0)), 2)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard boom"):
        ps_transform([[1, 2], [3, 4]], [Puller(), Puller()], store,
                     pull_limit=1, iteration_wait_time=WAIT)
    assert time.perf_counter() - t0 < 10.0


def test_worker_exception_fails_the_run_promptly():
    class Boom:
        def on_recv(self, x, ps):
            raise RuntimeError("boom")

        def on_pull_answer(self, a, ps):
            pass

        def close(self, ps):
            pass

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="boom"):
        ps_transform([[1]], [Boom()], make_store(),
                     iteration_wait_time=WAIT)
    assert time.perf_counter() - t0 < 10.0


def test_idle_topology_times_out():
    """A pull no shard ever answers leaves the topology silent: the idle
    window raises instead of hanging."""

    class Mute(SimplePSLogic):
        def on_pull(self, ids):
            time.sleep(3.0)
            return super().on_pull(ids)

    class Puller:
        def on_recv(self, x, ps):
            ps.pull(np.array([1]))

        def on_pull_answer(self, a, ps):
            pass

        def close(self, ps):
            pass

    store = ShardedParameterStore(
        lambda p: Mute(PseudoRandomFactorInitializer(2, scale=0.0)), 1)
    with pytest.raises(TimeoutError, match="idle"):
        ps_transform([[0]], [Puller()], store, iteration_wait_time=1.0)


# -- PS offline MF: parity on deterministic topologies ------------------------


@pytest.mark.parametrize("workers,shards,pull_limit", [
    (1, 1, 1), (1, 1, 2), (1, 3, 1)])
@pytest.mark.parametrize("schedule", ["constant", "inverse_sqrt"])
def test_offline_matches_jax(monkeypatch, workers, shards, pull_limit,
                             schedule):
    patch_ps(monkeypatch, [jmf], [pmf], rank=8)
    train, test = planted(n=3000)
    kw = dict(num_factors=8, iterations=4, learning_rate=0.05,
              lr_schedule=schedule, worker_parallelism=workers,
              ps_parallelism=shards, pull_limit=pull_limit, chunk_size=16,
              minibatch_size=32)
    j = jmf.PSOfflineMF(jmf.PSOfflineMFConfig(**kw))
    ju, ji = j.offline(jratings(train))
    p = PSOfflineMF(PSOfflineMFConfig(**kw), device="cpu")
    pu, pi = p.offline(train)
    assert_dicts_close(pu, ju, **TOL)
    assert_dicts_close(pi, ji, **TOL)
    assert abs(p.rmse(test) - j.rmse(jratings(test))) < 1e-5
    ru, ri, _, _ = test.to_numpy()
    np.testing.assert_allclose(p.predict(ru, ri), j.predict(ru, ri), **TOL)


def test_offline_converter_carries_the_model(monkeypatch):
    patch_ps(monkeypatch, [jmf], [], rank=8)
    train, test = planted(n=1500)
    j = jmf.PSOfflineMF(jmf.PSOfflineMFConfig(
        num_factors=8, iterations=2, worker_parallelism=2, ps_parallelism=2,
        chunk_size=16, minibatch_size=32))
    j.offline(jratings(train))
    p = convert.ps_offline_from_jax(j, device="cpu")
    assert p.config == PSOfflineMFConfig(**vars(j.config))
    assert p.rmse(test) == j.rmse(jratings(test))
    ru, ri, _, _ = test.to_numpy()
    s, seen = p.predict(np.append(ru, 10**6), np.append(ri, 3),
                        return_mask=True)
    assert not seen[-1] and s[-1] == 0.0


# -- PS offline MF: quality (the JAX tests' bars) -----------------------------


def test_single_worker_converges_to_floor(monkeypatch):
    jax_rows(monkeypatch, [pmf])
    train, test = planted()
    solver = PSOfflineMF(PSOfflineMFConfig(
        num_factors=8, iterations=20, learning_rate=0.05,
        lr_schedule="constant", worker_parallelism=1, ps_parallelism=1,
        pull_limit=2, chunk_size=16, minibatch_size=16), device="cpu")
    solver.offline(train)
    assert solver.rmse(test) < 0.1, solver.rmse(test)


def test_multiworker_async_learns(monkeypatch):
    jax_rows(monkeypatch, [pmf])
    train, test = planted()
    solver = PSOfflineMF(PSOfflineMFConfig(
        num_factors=8, iterations=12, learning_rate=0.2,
        worker_parallelism=4, ps_parallelism=2, pull_limit=2,
        chunk_size=16, minibatch_size=16), device="cpu")
    users, items = solver.offline(train)
    assert len(users) == 60 and len(items) == 40
    assert solver.rmse(test) < 0.1, solver.rmse(test)


def test_skewed_multiworker_matches_single_worker_floor(monkeypatch):
    jax_rows(monkeypatch, [pmf])
    train, test = planted(seed=3, skew=2.0)

    def run(workers):
        solver = PSOfflineMF(PSOfflineMFConfig(
            num_factors=8, iterations=15, learning_rate=0.1,
            worker_parallelism=workers, ps_parallelism=2, pull_limit=2,
            chunk_size=16, minibatch_size=16), device="cpu")
        solver.offline(train)
        return solver.rmse(test)

    r1, r4 = run(1), run(4)
    assert r1 < 0.1, r1
    assert r4 < 0.12, (r4, r1)


def test_empty_raises():
    with pytest.raises(ValueError):
        PSOfflineMF(device="cpu").offline(Ratings.from_arrays([], [], []))


def test_model_covers_all_ids(monkeypatch):
    jax_rows(monkeypatch, [pmf])
    gen = SyntheticMFGenerator(num_users=20, num_items=15, rank=3,
                               noise=0.1, seed=1)
    train = gen.generate(1000)
    users, items = PSOfflineMF(PSOfflineMFConfig(
        num_factors=4, iterations=2, worker_parallelism=2, ps_parallelism=2,
        chunk_size=8, minibatch_size=32), device="cpu").offline(train)
    ru, ri, _, _ = train.to_numpy()
    assert set(np.unique(ru).tolist()) <= set(users)
    assert set(np.unique(ri).tolist()) <= set(items)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (PSOfflineMF, lambda: convert.ps_offline_from_jax(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
