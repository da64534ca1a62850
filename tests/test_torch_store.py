"""The port's tiered factor store (``store.tiered``, ``store.prefetch``) and
the seams that connect it (``StreamingDriver``'s prefetch branch,
``ServingEngine(user_store=)``, the online checkpoint's hot rows), on the
CPU.

The invariant: on the CPU (sequential ``index_add_``) tiered training and
serving are BIT-EQUAL with the untiered run at every pool size that holds
the concurrently pinned working set (8 slots, 64 and the whole table
here, serial and with two row-disjoint concurrent consumers); the tier
moves bytes, never values. Against the JAX package: the same batches
through both packages' tiered ``OnlineMF`` (one numpy table behind both
initializers) take the same slot decisions (maps, pins, dirty bits,
ticks, counters: equal) and hold values within the online bar (rtol 1e-5
/ atol 1e-6 after every batch, XLA against torch sums); and
``convert.tiered_store_from_jax`` continues a JAX store exactly (state
equal at conversion, then the same decisions, values at the online bar).
"""

import os
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
from large_scale_recommendation_tpu.store import (
    TieredFactorStore as JTiered,
)
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.serving import ServingEngine
from large_scale_recommendation_tpu_torch.store import (
    StorePrefetcher,
    StoreStats,
    TieredFactorStore,
)
from large_scale_recommendation_tpu_torch.streams import (
    EventLog,
    StreamingDriver,
    StreamingDriverConfig,
)
from large_scale_recommendation_tpu_torch.streams.parallel import (
    RowConflictGate,
)
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_online_state,
    save_online_state,
)

RANK = 4
ONLINE_TOL = dict(rtol=1e-5, atol=1e-6)
_INIT = np.random.default_rng(5).uniform(
    0.0, 0.1, (4096, RANK)).astype(np.float32)


@pytest.fixture(autouse=True)
def _reset_jax_store_plane():
    """A store of either package installs itself as its package's obs
    STORE plane."""
    from large_scale_recommendation_tpu.obs.store import get_store, set_store
    from large_scale_recommendation_tpu_torch.obs import store as pstore

    prev = (get_store(), pstore.get_store())
    yield
    set_store(prev[0])
    pstore.set_store(prev[1])


def tiered(slots, capacity=64, mmap_dir=None, init=None):
    cfg = OnlineMFConfig(num_factors=RANK)
    return TieredFactorStore(
        init or PseudoRandomFactorInitializer(RANK, scale=cfg.init_scale),
        capacity=capacity, slot_capacity=slots, device="cpu",
        mmap_dir=mmap_dir)


def model(slots=None, mmap_dir=None):
    m = OnlineMF(OnlineMFConfig(num_factors=RANK, minibatch_size=32),
                 device="cpu")
    if slots is not None:
        m.users = tiered(slots, mmap_dir=mmap_dir)
    return m


def batches(n_batches=10, users=100, per_batch_users=8, items=24, seed=0,
            part=None):
    """Each batch touches exactly ``per_batch_users`` distinct users (3
    ratings each) of a universe no small pool holds. ``part=(p, n)``:
    users ≡ p (mod n) and items in block p (row-disjoint streams)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        if part is None:
            uu = rng.permutation(users)[:per_batch_users]
            i_lo = 0
        else:
            p, n = part
            uu = rng.choice(users // n, per_batch_users, replace=False) * n + p
            i_lo = p * items
        u = np.repeat(uu, 3).astype(np.int64)
        i = (rng.integers(0, items, u.size) + i_lo).astype(np.int64)
        out.append(Ratings.from_arrays(
            u, i, rng.random(u.size).astype(np.float32)))
    return out


def train(m, bs, **kw):
    for b in bs:
        m.partial_fit(b, emit_updates=False, **kw)
    return m


def table(m):
    return m.users.full_table()[:m.users.num_rows]


def by_id(m, side):
    t = getattr(m, side)
    ids = np.sort(t.id_array())
    return ids, t.lookup(ids)


# -- bit-equality across pool sizes -------------------------------------------


@pytest.mark.parametrize("slots", [8, 64, 128])
def test_tiered_matches_untiered_serially(slots):
    """8 slots hold one batch's 8 users and evict between batches; 128
    hold the whole table."""
    bs = batches()
    base = train(model(), bs)
    m = train(model(slots=slots), bs)
    st = m.users
    assert st.num_rows == base.users.num_rows
    assert torch.equal(table(m), table(base))
    assert torch.equal(m.items.array, base.items.array)
    probe_u, probe_i = [3, 50, 97, 12345], [1, 11, 23, 0]
    np.testing.assert_array_equal(m.predict(probe_u, probe_i),
                                  base.predict(probe_u, probe_i))
    assert m.rmse(bs[0]) == base.rmse(bs[0])
    snap = st.snapshot()
    assert snap["hot"]["pinned"] == 0
    assert st.stats.installs == st.num_rows
    if slots < st.num_rows:
        assert st.stats.evictions > 0 and st.stats.writebacks > 0
    else:
        assert st.stats.evictions == 0


@pytest.mark.parametrize("slots", [8, 64, 128])
def test_concurrent_disjoint_applies_match_serial(slots):
    """Two row-disjoint consumers (4 pinned users each: 8 fit an 8-slot
    pool together) evict and write back under both threads; by id, the
    tables equal the untiered serial run's."""
    streams = [batches(per_batch_users=4, part=(p, 2), seed=p)
               for p in range(2)]
    serial = model()
    for bs in streams:
        train(serial, bs)
    conc = model(slots=slots)
    conc.enable_concurrent_applies()
    conc.apply_gate = RowConflictGate()
    errs = []

    def consume(bs):
        try:
            train(conc, bs)
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=consume, args=(bs,))
               for bs in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert conc.step == serial.step
    for side in ("users", "items"):
        ids, a = by_id(serial, side)
        cids, b = by_id(conc, side)
        np.testing.assert_array_equal(ids, cids)
        np.testing.assert_array_equal(a, b)
    assert conc.users.snapshot()["hot"]["pinned"] == 0
    if slots < conc.users.num_rows:
        assert conc.users.stats.evictions > 0


def test_threads_under_a_short_switch_interval_stay_bit_equal():
    """Two row-disjoint consumers, the prefetcher and a serving reader on
    one 16-slot store, the interpreter switching threads every
    microsecond: by id, the tables equal the untiered serial run's and no
    pin leaks."""
    streams = [batches(per_batch_users=4, part=(p, 2), seed=p + 5)
               for p in range(2)]
    serial = model()
    for bs in streams:
        train(serial, bs)
    conc = model(slots=16)
    conc.enable_concurrent_applies()
    conc.apply_gate = RowConflictGate()
    pf = StorePrefetcher(conc.users).start()
    done, errs = threading.Event(), []

    def consume(bs):
        try:
            for b in bs:
                pf.submit(np.unique(b.users))
                conc.partial_fit(b, emit_updates=False)
        except BaseException as e:  # surfaced below
            errs.append(e)

    def serve():
        try:
            while not done.is_set():
                n = conc.users.num_rows
                if n:
                    conc.users.serve_rows(np.arange(n))
                time.sleep(0.001)
        except BaseException as e:  # surfaced below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumers = [threading.Thread(target=consume, args=(bs,))
                     for bs in streams]
        reader = threading.Thread(target=serve)
        for t in consumers + [reader]:
            t.start()
        for t in consumers:
            t.join(60)
        done.set()
        reader.join(60)
        pf.stop()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in consumers + [reader])
    assert not errs, errs
    for side in ("users", "items"):
        ids, a = by_id(serial, side)
        cids, b = by_id(conc, side)
        np.testing.assert_array_equal(ids, cids)
        np.testing.assert_array_equal(a, b)
    assert conc.users.snapshot()["hot"]["pinned"] == 0


def test_prefetcher_racing_the_trainer_stays_bit_equal():
    bs = batches()
    base = train(model(), bs)
    m = model(slots=16)
    pf = StorePrefetcher(m.users).start()
    try:
        for k, b in enumerate(bs):
            if k + 1 < len(bs):
                pf.submit(np.unique(bs[k + 1].users))  # the lookahead
            m.partial_fit(b, emit_updates=False)
        pf.drain()
    finally:
        pf.stop()
    assert not pf.running
    assert torch.equal(table(m), table(base))
    assert pf.submitted == len(bs) - 1


def test_mmap_backed_cold_tier_is_bit_equal(tmp_path):
    bs = batches(n_batches=6)
    base = train(model(), bs)
    m = train(model(slots=8, mmap_dir=str(tmp_path)), bs)
    assert torch.equal(table(m), table(base))
    assert any(f.startswith("cold_") for f in os.listdir(tmp_path))
    assert m.users.snapshot()["cold"]["mmap"] is True


# -- the two rules, the overcommit, LRU write-back ----------------------------


def test_prefetch_hits_cut_demand_misses():
    st = tiered(slots=32)
    ids = np.arange(20)
    st.ensure(ids)  # registered: rows land cold
    assert st.prefetch(ids) == 20
    assert st.stats.prefetched == 20 and st.stats.misses == 0
    rows = st.acquire_rows(ids)
    st.release_rows(rows)
    assert st.stats.hits == 20 and st.stats.misses == 0
    assert st.stats.hit_rate == 1.0


def test_prefetch_never_registers_ids():
    st = tiered(slots=32)
    assert st.prefetch(np.arange(50, 70)) == 0
    assert st.num_rows == 0 and st.stats.prefetched == 0
    rows = st.acquire_rows(np.asarray([60, 55, 50]))
    st.release_rows(rows)
    r, found = st.rows_for(np.asarray([60, 55, 50]))
    assert (found > 0).all()
    np.testing.assert_array_equal(r, [0, 1, 2])  # training's first-seen order
    # first-seen registrations are installs, not tier misses
    assert st.stats.installs == 3 and st.stats.misses == 0
    assert st.stats.hit_rate == 1.0


def test_overcommit_raises_with_accounting_and_leaks_no_pin():
    st = tiered(slots=8)
    held = st.acquire_rows(np.arange(4))  # 4 pinned
    with pytest.raises(RuntimeError, match="overcommitted") as e:
        st.acquire_rows(np.arange(2, 12))  # 2 hot (pinned again) + 8 misses
    assert "need 8 slots" in str(e.value) and "(4 pinned)" in str(e.value)
    assert st.snapshot()["hot"]["pinned"] == 4  # only the first acquire's
    st.release_rows(held)
    assert st.snapshot()["hot"]["pinned"] == 0
    rows = st.acquire_rows(np.arange(8))  # a pool-sized set: fine
    st.release_rows(rows)
    assert st.snapshot()["hot"]["pinned"] == 0


def test_lru_eviction_writes_dirty_rows_back():
    st = tiered(slots=8)
    ids = np.arange(8)
    slots = st.acquire_rows(ids)
    trained = st.array.clone()
    trained[torch.from_numpy(slots)] += 1.0  # a training step, in effect
    st.install_trained(trained, slots)
    st.release_rows(slots)
    want = st.lookup(ids)
    # touch 2..7 again: 0 and 1 are now the least recently used
    st.release_rows(st.acquire_rows(ids[2:]))
    assert set(st.dirty_rows().tolist()) == set(range(8))
    st.release_rows(st.acquire_rows(np.asarray([100, 101])))
    assert set(st.resident_rows().tolist()) == set(range(2, 10))
    assert st.stats.evictions == 2 and st.stats.writebacks == 2
    # the evicted rows' trained values reached the cold tier
    np.testing.assert_array_equal(st.cold[:2], want[:2])
    np.testing.assert_array_equal(st.lookup(ids), want)


def test_serve_rows_merges_hot_and_cold_read_only():
    m = train(model(slots=8), batches(n_batches=5))
    st = m.users
    before = set(st.resident_rows().tolist())
    n = st.num_rows
    got = st.serve_rows(np.arange(n))
    assert torch.equal(got, st.full_table()[:n])
    assert set(st.resident_rows().tolist()) == before
    assert st.stats.serve_hits + st.stats.serve_misses == n
    assert st.stats.serve_hits == len(before) and st.stats.serve_misses > 0
    assert st.serve_rows(np.zeros(0, np.int64)).shape == (0, RANK)


def test_stats_snapshot_keys_match_jax():
    from large_scale_recommendation_tpu.store import StoreStats as JStats

    assert StoreStats().snapshot().keys() == JStats().snapshot().keys()
    assert (tiered(8).snapshot().keys()
            == {"hot", "cold", "rank", "stats"})


# -- checkpoint, driver, serving ----------------------------------------------


def test_restart_with_dirty_pool_rewarms_and_resumes_bit_equal(tmp_path):
    bs = batches()
    full = train(model(slots=8), bs)
    m = train(model(slots=8), bs[:5], offset=(0, 5))
    assert m.users.dirty_rows().size > 0  # dirty at capture
    mgr = CheckpointManager(str(tmp_path))
    save_online_state(mgr, m, step=5)
    ck = mgr.restore()
    np.testing.assert_array_equal(ck["user_hot_rows"],
                                  m.users.resident_rows())
    assert "item_hot_rows" not in ck.arrays  # a plain table has none
    fresh = model(slots=8)
    restore_online_state(mgr, fresh)
    assert fresh.consumed_offsets == {0: 5}
    assert torch.equal(table(fresh), table(m))
    assert set(fresh.users.resident_rows().tolist()) == \
        set(m.users.resident_rows().tolist())
    assert fresh.users.dirty_rows().size == 0  # re-warmed clean
    train(fresh, bs[5:])
    assert torch.equal(table(fresh), table(full))


def test_tiered_checkpoint_restores_into_a_plain_model_and_back(tmp_path):
    m = train(model(slots=8), batches(n_batches=4))
    mgr = CheckpointManager(str(tmp_path))
    save_online_state(mgr, m, step=4)
    plain = model()
    restore_online_state(mgr, plain)
    assert torch.equal(table(plain), table(m))
    mgr2 = CheckpointManager(str(tmp_path / "plain"))
    save_online_state(mgr2, plain, step=4)
    again = model(slots=8)
    restore_online_state(mgr2, again)  # no hot rows saved: nothing warmed
    assert torch.equal(table(again), table(m))
    assert again.users.resident_rows().size == 0


def test_driver_with_prefetcher_equals_driver_without(tmp_path):
    bs = batches(n_batches=12)
    log = EventLog(str(tmp_path / "log"), fsync=False)
    for b in bs:
        log.append(0, b)
    cfg = StreamingDriverConfig(batch_records=24, checkpoint_every=4,
                                queue_capacity=2)
    plain, tier = model(), model(slots=8)
    d0 = StreamingDriver(plain, log, str(tmp_path / "c0"), config=cfg)
    d1 = StreamingDriver(tier, log, str(tmp_path / "c1"), config=cfg)
    assert d0.run() == d1.run() == 12
    assert torch.equal(table(tier), table(plain))
    assert torch.equal(tier.items.array, plain.items.array)
    pf = d1._last_stats["prefetch"]
    assert pf["submitted"] == 12 and not pf["running"]
    assert "prefetch" not in d0._last_stats
    log.close()


def test_engine_on_the_store_lists_equal_the_untiered_engines():
    bs = batches(n_batches=8)
    plain, tier = train(model(), bs), train(model(slots=8), bs)
    ids = np.unique(np.concatenate([b.users for b in bs]))
    ids = np.append(ids, 10**6)  # an unknown user: -1 / 0.0
    want = ServingEngine(plain.to_model(), k=5).recommend(ids)
    eng = ServingEngine(tier.to_model(), k=5, user_store=tier.users)
    got = eng.recommend(ids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tier.users.stats.serve_misses > 0
    # more training: the store is the live user state, no refresh needed
    # for the user side, and a user-side delta is ignored
    train(plain, bs[:2])
    train(tier, bs[:2])
    eng.apply_delta(user_rows=np.arange(3), U_rows=np.zeros((3, RANK)))
    eng.refresh(tier.to_model())
    want = ServingEngine(plain.to_model(), k=5).recommend(ids)
    got = eng.recommend(ids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -- against the JAX package ------------------------------------------------


def _inits():
    jinit = JFunctionInit(RANK, lambda ids: jnp.asarray(
        _INIT[np.asarray(ids)]))
    pinit = FunctionFactorInitializer(RANK, lambda ids: torch.from_numpy(
        _INIT[ids.cpu().numpy()]))
    return jinit, pinit


def _pair(slots):
    jinit, pinit = _inits()
    jm = JOnline(JConfig(num_factors=RANK, minibatch_size=32),
                 user_initializer=jinit, item_initializer=jinit)
    jm.users = JTiered(jinit, capacity=64, slot_capacity=slots)
    pm = OnlineMF(OnlineMFConfig(num_factors=RANK, minibatch_size=32),
                  user_initializer=pinit, item_initializer=pinit,
                  device="cpu")
    pm.users = tiered(slots, init=pinit)
    return jm, pm


_MAPS = ("_row_slot", "_slot_row", "_slot_dirty", "_slot_pin", "_slot_tick")


def assert_same_store(p, j):
    assert (p.capacity, p.num_rows, p._tick) == (j.capacity, j.num_rows,
                                                 j._tick)
    np.testing.assert_array_equal(p.id_array(), j.id_array())
    for f in _MAPS:
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
    js = j.stats.snapshot()
    ps = p.stats.snapshot()
    for k in ps:
        if k != "demand_fault_s":
            assert ps[k] == js[k], k


@pytest.mark.parametrize("slots", [8, 64])
def test_tiered_store_matches_jax_slot_for_slot(slots):
    jm, pm = _pair(slots)
    for b in batches():
        jm.partial_fit(JRatings.from_arrays(*b.to_numpy()),
                       emit_updates=False)
        pm.partial_fit(b, emit_updates=False)
        assert_same_store(pm.users, jm.users)
        np.testing.assert_allclose(pm.users.array.numpy(),
                                   np.asarray(jm.users.array), **ONLINE_TOL)
        np.testing.assert_allclose(
            table(pm).numpy(),
            np.asarray(jm.users.full_table())[:jm.users.num_rows],
            **ONLINE_TOL)


def test_tiered_store_from_jax_continues_the_jax_store():
    bs = batches(n_batches=8)
    jm, _ = _pair(8)
    for b in bs[:4]:
        jm.partial_fit(JRatings.from_arrays(*b.to_numpy()),
                       emit_updates=False)
    _, pinit = _inits()
    st = convert.tiered_store_from_jax(jm.users, device="cpu",
                                       initializer=pinit)
    assert_same_store(st, jm.users)
    np.testing.assert_array_equal(st.cold, np.asarray(jm.users.cold))
    np.testing.assert_array_equal(st.array.numpy(),
                                  np.asarray(jm.users.array))
    pm = convert.online_from_jax(jm, device="cpu", item_initializer=pinit)
    pm.users = st
    np.testing.assert_array_equal(
        table(pm).numpy(),
        np.asarray(jm.users.full_table())[:jm.users.num_rows])
    for b in bs[4:]:
        jm.partial_fit(JRatings.from_arrays(*b.to_numpy()),
                       emit_updates=False)
        pm.partial_fit(b, emit_updates=False)
        assert_same_store(pm.users, jm.users)
        np.testing.assert_allclose(
            table(pm).numpy(),
            np.asarray(jm.users.full_table())[:jm.users.num_rows],
            **ONLINE_TOL)


# -- the STORE plane and the registry gauges ----------------------------------


@pytest.fixture
def both_obs_live():
    """Live registries in both packages; the defaults restored after."""
    from large_scale_recommendation_tpu import obs as jobs
    from large_scale_recommendation_tpu.obs import registry as jreg
    from large_scale_recommendation_tpu_torch import obs

    jprev, pprev = jreg.get_registry(), obs.get_registry()
    jr, _ = jobs.enable()
    pr, _ = obs.enable()
    yield jr, pr
    jreg.set_registry(jprev)
    obs.disable()
    obs.set_registry(pprev)


def test_storez_equals_the_jax_snapshot_and_gauges_match(both_obs_live):
    """The same batches through both packages' tiered models (8 slots: the
    pool evicts): the port's ``/storez`` body equals the JAX store's live
    ``snapshot()`` (the demand-fault wall compared for presence), and the
    registry gauges carry the same values."""
    from large_scale_recommendation_tpu.obs.store import storez as jstorez
    from large_scale_recommendation_tpu_torch.obs.store import storez

    jr, pr = both_obs_live
    jm, pm = _pair(8)
    assert storez() == pm.users.snapshot()
    for b in batches():
        jm.partial_fit(JRatings.from_arrays(*b.to_numpy()),
                       emit_updates=False)
        pm.partial_fit(b, emit_updates=False)
        js, ps = jstorez(), storez()
        assert js["stats"].pop("demand_fault_s") >= 0.0
        assert ps["stats"].pop("demand_fault_s") >= 0.0
        assert ps == js
    assert ps["stats"]["evictions"] > 0 and ps["stats"]["hits"] > 0
    for name in ("tier_hit_rate", "tier_evictions_total", "tier_host_bytes"):
        (jv,), (pv,) = ([m.value for m in r.find(name)] for r in (jr, pr))
        assert pv == jv, name
    assert [m.value >= 0 for m in pr.find("tier_prefetch_wait_s")] == [True]


def test_store_memory_watch_reads_the_host_bytes_series(both_obs_live):
    from large_scale_recommendation_tpu_torch.obs.health import (
        OK,
        HealthMonitor,
    )
    from large_scale_recommendation_tpu_torch.obs.recorder import (
        FlightRecorder,
    )

    _, pr = both_obs_live
    rec = FlightRecorder(registry=pr)
    mon = HealthMonitor(registry=pr)
    mon.watch_store_memory(rec)
    store = tiered(8, capacity=8)
    for i in range(6):  # the cold tier doubles once: growth, then a plateau
        store.ensure(np.arange(4 * i, 4 * i + 4))
        rec.sample()
    assert "tier_host_bytes" in rec.series_names()
    report = mon.run()
    assert report["status"] == OK
    assert report["checks"]["store_memory"]["detail"]["series"] == \
        "tier_host_bytes"


def test_null_registry_binds_no_store_gauges():
    from large_scale_recommendation_tpu_torch.obs import store as pstore
    from large_scale_recommendation_tpu_torch.obs.registry import (
        NULL_INSTRUMENT,
    )

    store = tiered(8)
    assert store._obs_on is False and store._m_hit_rate is NULL_INSTRUMENT
    assert pstore.get_store() is store  # the latest store wins


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: TieredFactorStore(
            PseudoRandomFactorInitializer(RANK)),
                  lambda: convert.tiered_store_from_jax(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


def test_transfer_ledger_notes_reconcile_with_the_stats_as_jax(
        both_obs_live):
    """With a transfer ledger installed, the same batches through both
    packages' tiered models (8 slots: the pool evicts and writes back)
    note the same sites with the same logical bytes and counts, and the
    bytes reconcile with ``StoreStats``: demand faults = (misses +
    installs) rows, write-backs and serve misses likewise."""
    from large_scale_recommendation_tpu.obs import transfers as jtx
    from large_scale_recommendation_tpu_torch import obs

    jprev = jtx.get_transfers()
    jl = jtx.TransferLedger()
    jtx.set_transfers(jl)
    pl = obs.enable_transfers(watch_hot=False)
    try:
        jm, pm = _pair(8)
        for b in batches():
            jm.partial_fit(JRatings.from_arrays(*b.to_numpy()),
                           emit_updates=False)
            pm.partial_fit(b, emit_updates=False)
        rows = np.arange(40)
        jm.users.serve_rows(rows)
        pm.users.serve_rows(rows)
    finally:
        jtx.set_transfers(jprev)

    def sites(ledger):
        return {name: {k: v for k, v in row.items()
                       if k in ("h2d_bytes", "d2h_bytes", "h2d_count",
                                "d2h_count")}
                for name, row in ledger.snapshot()["sites"].items()
                if name.startswith("store.")}

    ps, js = sites(pl), sites(jl)
    assert ps == js
    st, row = pm.users.stats, 4 * RANK
    assert ps["store.demand_fault"]["h2d_bytes"] == \
        (st.misses + st.installs) * row
    assert ps["store.writeback"]["d2h_bytes"] == st.writebacks * row
    assert ps["store.serve_cold"]["h2d_bytes"] == st.serve_misses * row
    assert st.writebacks > 0 and st.serve_misses > 0
