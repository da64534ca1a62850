"""The port's parallel ingest (``streams/parallel.py`` and the concurrent
applies of ``models/online.py``) on the CPU: the row-conflict gate's
grants and blocking; row-disjoint concurrent applies bit-equal to the
serial order; updates id-aligned as in the JAX package; the runner's
barrier, resume, fault propagation, frozen-stamp hold, refresh coalescing
and single-version swap; and the runner against a JAX runner on the same
stratum-routed log (tables within rtol 1e-5 / atol 1e-6). Every thread a
test starts is joined with a timeout; ordering comes from events."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.initializers import (
    FunctionFactorInitializer as JFunctionInit,
)
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.models.online import OnlineMF as JOnline
from large_scale_recommendation_tpu.models.online import (
    OnlineMFConfig as JConfig,
)
from large_scale_recommendation_tpu.streams import (
    ParallelIngestRunner as JRunner,
)
from large_scale_recommendation_tpu.streams import (
    StreamingDriverConfig as JDriverConfig,
)
from large_scale_recommendation_tpu.streams import log as jlog
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.streams import (
    EventLog,
    ParallelIngestRunner,
    RowConflictGate,
    StreamingDriver,
    StreamingDriverConfig,
    append_routed,
    route_partition,
)
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

TOL = dict(rtol=1e-5, atol=1e-6)
RANK = 4
_INIT = np.random.default_rng(7).uniform(
    -0.3, 0.3, (1024, RANK)).astype(np.float32)


def _online(pkg="port"):
    if pkg == "jax":
        init = JFunctionInit(RANK, lambda ids: jnp.asarray(
            _INIT[np.asarray(ids)]))
        return JOnline(JConfig(num_factors=RANK, minibatch_size=64,
                               learning_rate=0.05),
                       user_initializer=init, item_initializer=init)
    init = FunctionFactorInitializer(
        RANK, lambda ids: torch.from_numpy(_INIT[ids.cpu().numpy()]))
    return OnlineMF(OnlineMFConfig(num_factors=RANK, minibatch_size=64,
                                   learning_rate=0.05),
                    user_initializer=init, item_initializer=init,
                    device="cpu")


def _fill_strata(log, n, n_batches, batch=300, seed=0, users=30, items=12,
                 per_partition=None):
    """Stratum-routed fill: partition p's users ≡ p (mod n), its items in
    block p — fully row-disjoint streams."""
    rng = np.random.default_rng(seed)
    for p in range(n):
        for _ in range(n_batches if per_partition is None
                       else per_partition[p]):
            u = rng.integers(0, users, batch) * n + p
            i = rng.integers(0, items, batch) + p * items
            log.append_arrays(p, u, i, rng.random(batch).astype(np.float32))


def _runner(tmp_path, log, model=None, sub="ckpt", **cfg):
    model = model or _online()
    return model, ParallelIngestRunner(
        model, log, str(tmp_path / sub),
        config=StreamingDriverConfig(batch_records=300, **cfg))


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.001)


def _join(threads, timeout=60):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# -- routing and the gate ----------------------------------------------------

def test_routing_is_user_stable_and_splits_the_log(tmp_path):
    assert route_partition([0, 1, 5, 9, 1, 5], 4).tolist() == \
        [0, 1, 1, 1, 1, 1]
    with pytest.raises(ValueError):
        route_partition([1], 0)
    log = EventLog(str(tmp_path), num_partitions=3, fsync=False)
    users = np.arange(12)
    assert append_routed(log, users, users, np.ones(12, np.float32)) == 12
    for p in range(3):
        batch, _ = log.read(p, 0, 100)
        assert (route_partition(batch.users, 3) == p).all()


def test_gate_grants_disjoint_claims_at_once():
    gate = RowConflictGate()
    t1 = gate.acquire([1, 2], [10])
    t2 = gate.acquire([3], [11, 12])
    assert (gate.grants, gate.waits, gate.in_flight()) == (2, 0, (3, 3))
    gate.release(t1)
    gate.release(t2)
    assert gate.in_flight() == (0, 0)


@pytest.mark.parametrize("claim", [([2], [10]), ([1], [99])],
                         ids=["item", "user"])
def test_gate_blocks_a_collision_until_release(claim):
    gate = RowConflictGate()
    held = gate.acquire([1], [10])
    acquired = threading.Event()

    def contender():
        gate.release(gate.acquire(*claim))
        acquired.set()

    t = threading.Thread(target=contender)
    t.start()
    _wait_for(lambda: gate.waits == 1)  # it is inside the wait
    assert not acquired.is_set()
    gate.release(held)
    assert acquired.wait(30)
    _join([t])
    assert gate.grants == 2 and gate.in_flight() == (0, 0)


# -- concurrent applies ------------------------------------------------------

def _streams(n_parts=4, n_batches=3, batch=200, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n_parts):
        bs = []
        for _ in range(n_batches):
            u = rng.integers(0, 20, batch) * n_parts + p
            i = rng.integers(0, 10, batch) + p * 10
            bs.append((u, i, rng.random(batch).astype(np.float32)))
        out.append(bs)
    return out


def test_disjoint_concurrent_applies_equal_the_serial_order_bitexact():
    """Ten consumer threads (more than the cores of an 8-core host), a short
    switch interval: a lost commit would break the bit-equality."""
    streams = _streams(n_parts=10)
    serial, jserial = _online(), _online("jax")
    for bs in streams:
        for b in bs:
            serial.partial_fit(Ratings.from_arrays(*b), emit_updates=False)
            jserial.partial_fit(JRatings.from_arrays(*b),
                                emit_updates=False)
    conc = _online()
    conc.enable_concurrent_applies()
    conc.apply_gate = RowConflictGate()
    assert conc.concurrent_applies
    start, errors = threading.Barrier(len(streams)), []

    def consume(bs):
        try:
            start.wait(30)
            for b in bs:
                conc.partial_fit(Ratings.from_arrays(*b), emit_updates=False)
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=consume, args=(bs,))
               for bs in streams]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert conc.step == serial.step == 30
    for side in ("users", "items"):
        st, ct = getattr(serial, side), getattr(conc, side)
        ids = np.sort(st.id_array())
        np.testing.assert_array_equal(ids, np.sort(ct.id_array()))
        np.testing.assert_array_equal(st.lookup(ids), ct.lookup(ids))
        np.testing.assert_allclose(
            ct.lookup(ids), np.asarray(getattr(jserial, side).lookup(ids)),
            **TOL)


def test_concurrent_updates_are_id_aligned_as_in_jax():
    m, jm = _online(), _online("jax")
    m.enable_concurrent_applies()
    jm.enable_concurrent_applies()
    args = ([9, 3, 7, 3], [20, 5, 11, 20], [1.0, 2.0, 3.0, 4.0])
    out = m.partial_fit(Ratings.from_arrays(*args))
    jout = jm.partial_fit(JRatings.from_arrays(*args))
    for side, table in (("user_arrays", m.users), ("item_arrays", m.items)):
        ids, vecs = getattr(out, side)
        jids, jvecs = getattr(jout, side)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(vecs, jvecs, **TOL)
        np.testing.assert_array_equal(vecs, table.lookup(ids))
    assert out.user_arrays[0].tolist() == [3, 7, 9]


def test_colliding_applies_serialize_and_both_land():
    m = _online()
    m.enable_concurrent_applies()
    m.apply_gate = RowConflictGate()
    start = threading.Barrier(2)

    def apply(u, r):
        start.wait(30)
        m.partial_fit(Ratings.from_arrays([u], [7], [r]), emit_updates=False)

    threads = [threading.Thread(target=apply, args=a)
               for a in ((1, 1.0), (2, 2.0))]
    for t in threads:
        t.start()
    _join(threads)
    assert m.step == 2 and m.apply_gate.grants == 2
    assert np.isfinite(m.items.lookup([7])).all()


def test_offset_stamp_and_watchdog_around_the_commit():
    m = _online()
    m.enable_concurrent_applies()
    m.partial_fit(Ratings.from_arrays([1], [2], [1.0]), offset=(3, 17),
                  emit_updates=False)
    assert m.consumed_offsets == {3: 17}
    m.partial_fit(Ratings.from_arrays([0], [0], [1.0], weights=[0.0]),
                  offset=(3, 20), emit_updates=False)
    assert m.consumed_offsets == {3: 20}
    before = m.users.lookup([1]).copy()

    class Trip:
        def after_batch(self, model, U, V, u_rows, i_rows):
            raise RuntimeError("tripped")

    m.watchdog = Trip()
    with pytest.raises(RuntimeError, match="tripped"):
        m.partial_fit(Ratings.from_arrays([5], [6], [1.0]), offset=(3, 21))
    # the tripped batch reached neither the live tables nor the stamp (its
    # new ids are registered, at their initial values)
    np.testing.assert_array_equal(m.users.lookup([1]), before)
    np.testing.assert_array_equal(m.users.lookup([5])[0], _INIT[5])
    assert m.consumed_offsets == {3: 20} and m.step == 1


# -- the runner --------------------------------------------------------------

def test_runner_drains_every_partition_behind_one_barrier(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=4, fsync=False)
    _fill_strata(log, 4, 3)
    model, runner = _runner(tmp_path, log, checkpoint_every=2)
    assert not runner.resume()
    assert runner.run() == 12
    tele = runner.telemetry()
    assert all(v == 0 for v in tele["lag_records"].values())
    assert model.consumed_offsets == {p: 900 for p in range(4)}
    assert runner.checkpoints_written >= 1 and tele["gate"]["grants"] == 12
    ck = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert ck.meta["offsets"] == {str(p): 900 for p in range(4)}


def test_runner_resumes_every_partition(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=3, fsync=False)
    _fill_strata(log, 3, 2)
    _runner(tmp_path, log)[1].run()
    _fill_strata(log, 3, 1, seed=9)
    m2, r2 = _runner(tmp_path, log)
    assert r2.resume() and m2.consumed_offsets == {p: 600 for p in range(3)}
    assert r2.run() == 3
    assert m2.consumed_offsets == {p: 900 for p in range(3)}


def test_single_partition_runner_stays_serial(tmp_path):
    log = EventLog(str(tmp_path / "log"), fsync=False)
    _fill_strata(log, 1, 3)
    model, runner = _runner(tmp_path, log)
    assert runner.gate is None and not model.concurrent_applies
    assert runner.run() == 3


def test_a_consumer_fault_stops_all_and_is_reraised(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    _fill_strata(log, 2, 50)

    class Boom(RuntimeError):
        pass

    def explode(batch):
        if batch.partition == 1:
            raise Boom()

    model, runner = _runner(tmp_path, log)
    runner.on_batch = explode
    with pytest.raises(Boom):
        runner.run()
    assert model.consumed_offsets.get(0, 0) < 50 * 300
    runner.on_batch = None
    assert runner.run() > 0  # a fresh run after the fault drains


def test_barrier_holds_while_stamps_are_frozen(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    _fill_strata(log, 2, 3)
    model, runner = _runner(tmp_path, log, checkpoint_every=1)
    real_fit, lock, frozen = model.partial_fit, threading.Lock(), [2]

    def fit(batch, offset=None, emit_updates=False, **kw):
        with lock:
            if offset is not None and offset[0] == 0 and frozen[0] > 0:
                frozen[0] -= 1
                offset = None
        return real_fit(batch, offset=offset, emit_updates=emit_updates,
                        **kw)

    model.partial_fit = fit
    runner.run()
    assert runner.barriers_held >= 1 and runner.checkpoints_written >= 1
    ck = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert ck.meta["offsets"] == {"0": 900, "1": 900}


class _Crash(RuntimeError):
    pass


def test_kill_and_resume_lose_nothing_per_partition(tmp_path):
    n, batch, every = 3, 300, 2
    per_partition = [4 + p for p in range(n)]
    log = EventLog(str(tmp_path / "log"), num_partitions=n, fsync=False)
    _fill_strata(log, n, 0, batch=batch, per_partition=per_partition)
    applied, lock = [], threading.Lock()

    def record_and_crash(b):
        with lock:
            applied.append((b.partition, b.start_offset, b.end_offset))
            if len(applied) == 6:
                raise _Crash()

    _, r1 = _runner(tmp_path, log, checkpoint_every=every)
    r1.on_batch = record_and_crash
    with pytest.raises(_Crash):
        r1.run()
    frontier = r1.applied_frontier()
    m2, r2 = _runner(tmp_path, log, checkpoint_every=every)
    r2.on_batch = lambda b: applied.append(
        (b.partition, b.start_offset, b.end_offset))
    assert r2.resume()
    for p in range(n):
        dup = frontier.get(p, 0) - m2.consumed_offsets.get(p, 0)
        assert 0 <= dup <= every * batch, (p, dup)
    r2.run()
    for p in range(n):
        covered = np.zeros(per_partition[p] * batch, np.int32)
        for part, lo, hi in applied:
            if part == p:
                covered[lo:hi] += 1
        assert (covered >= 1).all(), f"lost records in p{p}"
        assert (covered > 1).sum() <= every * batch
        assert m2.consumed_offsets[p] == per_partition[p] * batch


def test_one_refresh_is_one_version_for_n_consumers(tmp_path):
    n = 3
    log = EventLog(str(tmp_path / "log"), num_partitions=n, fsync=False)
    _fill_strata(log, n, 2)
    model, runner = _runner(tmp_path, log)
    runner.run()
    engine = runner.serving_engine(k=3, max_batch=32)
    at_bind = len(runner.catalog_versions)
    _fill_strata(log, n, 2, seed=7)
    runner.run()
    runner.refresh_serving(delta=True)
    assert len(runner.catalog_versions) == at_bind + 1
    assert engine.stats["delta_flushes"] == 1
    assert engine.stats["delta_swaps"] == 1
    U, V = engine.model.U.clone(), engine.model.V.clone()
    runner.refresh_serving(delta=False)  # the authoritative rebuild
    assert torch.equal(U, engine.model.U) and torch.equal(V, engine.model.V)


def test_concurrent_refresh_requests_coalesce(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    _fill_strata(log, 2, 2)
    model, runner = _runner(tmp_path, log)
    runner.run()
    runner.serving_engine(k=3, max_batch=32)
    entered, release = threading.Event(), threading.Event()
    real, calls = runner._do_refresh, [0]

    def held(delta):
        calls[0] += 1
        entered.set()
        assert release.wait(30)
        real(delta)

    runner._do_refresh = held
    t = threading.Thread(target=runner.refresh_serving)
    t.start()
    assert entered.wait(30)
    for _ in range(3):
        runner.refresh_serving()  # absorbed, returns at once
    assert runner.refreshes_coalesced == 3
    release.set()
    _join([t])
    assert calls[0] == 2 and not runner._refreshing  # one re-run for all


def test_vocab_growth_mid_ship_falls_back_to_a_full_refresh(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    _fill_strata(log, 2, 2)
    model, runner = _runner(tmp_path, log)
    runner.run()
    engine = runner.serving_engine(k=3, max_batch=32)
    _fill_strata(log, 2, 1, seed=5)
    runner.run()

    def grown(*a, **kw):
        raise ValueError("delta row 999 outside — vocab grew; use refresh()")

    real, engine.apply_delta = engine.apply_delta, grown
    refreshes = engine.stats["refreshes"]
    runner.refresh_serving(delta=None)
    assert engine.stats["refreshes"] == refreshes + 1
    _fill_strata(log, 2, 1, seed=6)
    runner.run()
    with pytest.raises(ValueError, match="vocab grew"):
        runner.refresh_serving(delta=True)
    engine.apply_delta = real


def test_stop_before_run_wins_and_start_join(tmp_path):
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    _fill_strata(log, 2, 3)
    drv = StreamingDriver(_online(), log, str(tmp_path / "d"), partition=0,
                          config=StreamingDriverConfig(batch_records=300))
    drv.stop()
    assert drv.run(follow=True) == 0
    assert drv.run() == 3
    model, runner = _runner(tmp_path, log)
    runner.start(follow=True)
    # both partitions drained before the stop (one partition's end says
    # nothing of the other consumer's)
    _wait_for(lambda: model.consumed_offsets == {0: 900, 1: 900})
    runner.stop()
    _join(runner._threads)
    runner.join()
    assert model.consumed_offsets == {0: 900, 1: 900}
    assert CheckpointManager(str(tmp_path / "ckpt")).restore().meta[
        "offsets"] == {"0": 900, "1": 900}


def test_runner_matches_a_jax_runner_on_the_same_routed_log(tmp_path):
    n = 4
    jl = jlog.EventLog(str(tmp_path / "log"), num_partitions=n, fsync=False)
    _fill_strata(jl, n, 3)
    jm, pm = _online("jax"), _online()
    jr = JRunner(jm, jl, str(tmp_path / "jck"),
                 config=JDriverConfig(batch_records=300, checkpoint_every=2))
    pr = ParallelIngestRunner(
        pm, EventLog(str(tmp_path / "log"), num_partitions=n, fsync=False),
        str(tmp_path / "pck"),
        config=StreamingDriverConfig(batch_records=300, checkpoint_every=2))
    assert pr.run() == jr.run() == 12
    assert pm.consumed_offsets == jm.consumed_offsets
    assert pm.step == jm.step == 12
    for side in ("users", "items"):
        pt, jt = getattr(pm, side), getattr(jm, side)
        ids = np.sort(pt.id_array())
        np.testing.assert_array_equal(ids, np.sort(jt.id_array()))
        np.testing.assert_allclose(pt.lookup(ids),
                                   np.asarray(jt.lookup(ids)), **TOL)
    ck, jck = (CheckpointManager(str(tmp_path / d)).restore()
               for d in ("pck", "jck"))
    assert ck.meta["offsets"] == jck.meta["offsets"]
    # a port runner resumes from the JAX runner's all-partition snapshot
    m3, r3 = _online(), None
    r3 = ParallelIngestRunner(
        m3, EventLog(str(tmp_path / "log"), num_partitions=n, fsync=False),
        str(tmp_path / "jck"),
        config=StreamingDriverConfig(batch_records=300))
    assert r3.resume() and m3.consumed_offsets == jm.consumed_offsets
    np.testing.assert_allclose(m3.users.lookup(ids := np.sort(
        m3.users.id_array())), np.asarray(jm.users.lookup(ids)), **TOL)
    # and a JAX runner resumes from the port's
    jm4 = _online("jax")
    j4 = JRunner(jm4, jl, str(tmp_path / "pck"),
                 config=JDriverConfig(batch_records=300))
    assert j4.resume() and jm4.consumed_offsets == pm.consumed_offsets


def test_runner_exports_every_partitions_lag(tmp_path):
    """``start_telemetry_export`` runs each member driver's cadence: every
    partition's ``streams_lag_records`` gauge tracks its own backlog, and
    ``stop_telemetry_export`` stops every exporter."""
    from large_scale_recommendation_tpu_torch import obs

    prev = obs.get_registry()
    reg, _ = obs.enable()
    try:
        log = EventLog(str(tmp_path / "log"), num_partitions=3, fsync=False)
        _fill_strata(log, 3, 1)
        _, runner = _runner(tmp_path, log)
        runner.run()
        _fill_strata(log, 3, 0, per_partition=[0, 1, 2], seed=4)
        runner.start_telemetry_export(0.02)
        tasks = [d._telemetry_task for d in runner.drivers.values()]
        gauges = [reg.gauge("streams_lag_records", partition=str(p))
                  for p in range(3)]
        _wait_for(lambda: [g.value for g in gauges] == [0, 300, 600])
        runner.stop_telemetry_export()
        assert not any(t.running for t in tasks)
        assert all(d._telemetry_task is None
                   for d in runner.drivers.values())
    finally:
        obs.disable()
        obs.set_registry(prev)
