"""The port's online MF (``data.tables``, ``ops.sgd.online_train``,
``models.online``) against the JAX package's, on the CPU, from the same
numpy inputs.

Both packages initialize rows through a ``FunctionFactorInitializer`` over
one numpy table, so the growable tables start bit-equal: ids → rows,
capacities, growth steps and arrays must stay bit-equal through installs
(no arithmetic). Trained tables: rtol 1e-5 / atol 1e-6 after every batch
(f32 sums in another order); the updates-only output: ids exactly, vectors
at the same bar.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.core.initializers import (
    FunctionFactorInitializer as JFunctionInit,
)
from large_scale_recommendation_tpu.core.updaters import (
    SGDUpdater as JSGDUpdater,
)
from large_scale_recommendation_tpu.core.updaters import (
    inverse_sqrt_lr as jinv_sqrt,
)
from large_scale_recommendation_tpu.data.tables import (
    GrowableFactorTable as JTable,
)
from large_scale_recommendation_tpu.models.online import OnlineMF as JOnline
from large_scale_recommendation_tpu.models.online import (
    OnlineMFConfig as JConfig,
)
from large_scale_recommendation_tpu.ops import sgd as jsgd
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import (
    FactorVector,
    ItemUpdate,
    Ratings,
    UserUpdate,
)
from large_scale_recommendation_tpu_torch.core.updaters import (
    SGDUpdater,
    inverse_sqrt_lr,
)
from large_scale_recommendation_tpu_torch.data.tables import (
    GrowableFactorTable,
)
from large_scale_recommendation_tpu_torch.models.online import (
    BatchUpdates,
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops

TOL = dict(rtol=1e-5, atol=1e-6)
RANK = 8
_INIT = np.random.default_rng(42).uniform(
    -0.3, 0.3, (200_000, RANK)).astype(np.float32)


def _inits(rank=RANK):
    """The same numpy rows behind both packages' initializers."""
    table = _INIT[:, :rank]
    jinit = JFunctionInit(rank, lambda ids: jnp.asarray(table[np.asarray(ids)]))
    pinit = FunctionFactorInitializer(
        rank, lambda ids: torch.from_numpy(table[ids.cpu().numpy()]))
    return jinit, pinit


def _tables(capacity):
    jinit, pinit = _inits()
    return (JTable(jinit, capacity=capacity),
            GrowableFactorTable(pinit, capacity=capacity, device="cpu"))


def _assert_same_table(p, j):
    assert p.capacity == j.capacity and p.num_rows == j.num_rows
    np.testing.assert_array_equal(p.id_array(), j.id_array())
    for a, b in zip(p.sorted_index(), j.sorted_index()):
        np.testing.assert_array_equal(a, b)
    assert p.array.dtype == torch.float32
    np.testing.assert_array_equal(p.array.numpy(), np.asarray(j.array))


# -- tables ------------------------------------------------------------------

ENSURES = {
    "growth": (8, [[5, 3, 5, 9], list(range(100, 140)), [3, 1000, 7, 1000],
                   list(range(2000, 2600)), [9, 2001, 77777]]),
    "exact_fill": (256, [list(range(200)), list(range(200, 256)), [999]]),
    "boundary": (64, [list(range(50)), list(range(50, 60)),
                      list(range(60, 70))]),
    "large_floor": (1 << 16, [list(range(5000)), list(range(4000, 70000)),
                              list(range(70000, 70100))]),
}


@pytest.mark.parametrize("name", sorted(ENSURES))
def test_table_ensure_is_bit_equal_to_jax(name):
    capacity, batches = ENSURES[name]
    jt, pt = _tables(capacity)
    for ids in batches:
        ids = np.asarray(ids)
        np.testing.assert_array_equal(pt.ensure(ids), jt.ensure(ids))
        _assert_same_table(pt, jt)
    probe = np.array([5, 42, 100, 123456, 9])
    for a, b in zip(pt.rows_for(probe), jt.rows_for(probe)):
        np.testing.assert_array_equal(a, b)
    assert pt.ids() == jt.ids()
    assert (9 in pt) == (9 in jt) and (424242 in pt) is False


def test_table_access_matches_jax():
    jt, pt = _tables(16)
    ids = np.array([7, 3, 11, 3, 40])
    jt.ensure(ids)
    pt.ensure(ids)
    np.testing.assert_array_equal(pt.lookup([11, 7]), np.asarray(
        jt.lookup(np.array([11, 7]))))
    pv = list(pt.factor_vectors([40, 3]))
    jv = list(jt.factor_vectors([40, 3]))
    assert [v.id for v in pv] == [v.id for v in jv] == [40, 3]
    np.testing.assert_array_equal(pv[1].factors, jv[1].factors)
    assert len(list(pt.factor_vectors())) == 4
    pd, jd = pt.as_dict(), jt.as_dict()
    assert sorted(pd) == sorted(jd)
    np.testing.assert_array_equal(pd[11], jd[11])
    np.testing.assert_array_equal(pt.gather_rows(np.array([2, 0])),
                                  jt.gather_rows(np.array([2, 0])))
    assert pt.gather_rows(np.array([], np.int64)).shape == (0, RANK)
    with pytest.raises(KeyError):
        pt.lookup([999])
    with pytest.raises(KeyError):
        list(pt.factor_vectors([999]))


def test_table_writes_build_new_tensors():
    """A reference to ``table.array`` keeps its values through installs,
    growth, restores and commits (the JAX arrays' immutability)."""
    _, pt = _tables(8)
    pt.ensure(np.array([1, 2, 3]))
    snap = pt.array
    before = snap.clone()
    view = pt.snapshot_rows(3)
    pt.ensure(np.arange(10, 40))  # install + growth
    pt.load_rows(np.array([0, 1]), np.ones((2, RANK), np.float32))
    upd = pt.array + 1.0
    pt.commit_rows(upd, np.array([2, 2, 2, 2]))
    assert torch.equal(snap, before) and torch.equal(view, before[:3])
    assert torch.equal(pt.array[0], torch.ones(RANK))
    assert torch.equal(pt.array[2], upd[2])
    jt, _ = _tables(8)
    jt.ensure(np.array([1, 2, 3]))
    jt.ensure(np.arange(10, 40))
    jt.load_rows(np.array([0, 1]), np.ones((2, RANK), np.float32))
    jt.commit_rows(jnp.asarray(np.asarray(jt.array) + 1.0),
                   np.array([2, 2, 2, 2]))
    np.testing.assert_array_equal(pt.array.numpy(), np.asarray(jt.array))


def test_table_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GrowableFactorTable(PseudoRandomFactorInitializer(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineMF(OnlineMFConfig())


# -- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("n,mb", [(0, 8), (1, 8), (17, 8), (64, 16),
                                  (1000, 128)])
def test_pad_minibatches_matches_jax(n, mb):
    rng = np.random.default_rng(n)
    u, i = rng.integers(0, 50, n), rng.integers(0, 50, n)
    r = rng.normal(size=n).astype(np.float32)
    got = sgd_ops.pad_minibatches(u, i, r, mb)
    want = jsgd.pad_minibatches(u, i, r, mb)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("collision", ["mean", "sum"])
@pytest.mark.parametrize("schedule", ["constant", "inverse_sqrt"])
def test_online_train_matches_jax(collision, schedule):
    rng = np.random.default_rng(3)
    n, mb = 600, 64
    u = rng.integers(0, 20, n)  # duplicates inside minibatches
    i = rng.integers(0, 30, n)
    r = rng.normal(size=n).astype(np.float32)
    ur, ir, vals, w = sgd_ops.pad_minibatches(u, i, r, mb)
    U = rng.uniform(-0.3, 0.3, (32, RANK)).astype(np.float32)
    V = rng.uniform(-0.3, 0.3, (32, RANK)).astype(np.float32)
    kw = dict(minibatch=mb, iterations=2, collision=collision, t0=3)
    if schedule == "constant":
        pupd, jupd = SGDUpdater(0.05), JSGDUpdater(0.05)
    else:
        pupd = SGDUpdater(0.05, schedule=inverse_sqrt_lr)
        jupd = JSGDUpdater(0.05, schedule=jinv_sqrt)
    Ut, Vt = torch.from_numpy(U.copy()), torch.from_numpy(V.copy())
    gU, gV = sgd_ops.online_train(
        Ut, Vt, *(torch.from_numpy(a) for a in (ur, ir, vals, w)),
        updater=pupd, **kw)
    jU, jV = jsgd.online_train(jnp.asarray(U), jnp.asarray(V),
                               jnp.asarray(ur), jnp.asarray(ir),
                               jnp.asarray(vals), jnp.asarray(w),
                               updater=jupd, **kw)
    np.testing.assert_allclose(gU.numpy(), np.asarray(jU), **TOL)
    np.testing.assert_allclose(gV.numpy(), np.asarray(jV), **TOL)
    # the inputs are untouched (trained copies come back)
    assert np.array_equal(Ut.numpy(), U) and np.array_equal(Vt.numpy(), V)


# -- the model ---------------------------------------------------------------


def _pair(collision="mean", iterations=1, mb=32, capacity=16, lr=0.05):
    jinit, pinit = _inits()
    kw = dict(num_factors=RANK, learning_rate=lr, minibatch_size=mb,
              init_capacity=capacity, collision_mode=collision,
              iterations_per_batch=iterations)
    j = JOnline(JConfig(**kw), user_initializer=jinit, item_initializer=jinit)
    p = OnlineMF(OnlineMFConfig(**kw), user_initializer=pinit,
                 item_initializer=pinit, device="cpu")
    return j, p


def _batches(n_batches=5, n=300, seed=0):
    gen = SyntheticMFGenerator(num_users=400, num_items=150, rank=4,
                               noise=0.1, seed=seed, skew_lam=2.0)
    return [gen.generate(n) for _ in range(n_batches)]


def _port(b):
    return Ratings.from_arrays(*b.to_numpy())


def _assert_close_model(p, j):
    for pt, jt in ((p.users, j.users), (p.items, j.items)):
        assert pt.capacity == jt.capacity
        np.testing.assert_array_equal(pt.id_array(), jt.id_array())
        n = jt.num_rows
        np.testing.assert_allclose(pt.array[:n].numpy(),
                                   np.asarray(jt.array[:n]), **TOL)
    assert p.step == j.step


@pytest.mark.parametrize("collision", ["mean", "sum"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_partial_fit_matches_jax_batch_by_batch(collision, iterations):
    j, p = _pair(collision, iterations)
    for b in _batches():
        ju = j.partial_fit(b)
        pu = p.partial_fit(_port(b))
        _assert_close_model(p, j)
        for side in ("user_arrays", "item_arrays"):
            (pi, pv), (ji, jv) = getattr(pu, side), getattr(ju, side)
            np.testing.assert_array_equal(pi, ji)
            assert pi.dtype == np.int64 and pv.dtype == np.float32
            np.testing.assert_allclose(pv, jv, **TOL)
        assert [u.vector.id for u in pu.user_updates] == \
            [u.vector.id for u in ju.user_updates]
        assert all(isinstance(x, (UserUpdate, ItemUpdate)) for x in pu)


def test_iterations_override_and_offsets():
    j, p = _pair()
    b1, b2 = _batches(2)
    j.partial_fit(b1, iterations=3, emit_updates=False, offset=(0, 10))
    assert p.partial_fit(_port(b1), iterations=3, emit_updates=False,
                         offset=(0, 10)) is None
    _assert_close_model(p, j)
    assert p.consumed_offsets == j.consumed_offsets == {0: 10}
    # an all-padding batch: no update, the position still advances
    pad = Ratings.from_arrays([1, 2], [3, 4], [5.0, 1.0], weights=[0.0, 0.0])
    before = p.users.array
    out = p.partial_fit(pad, offset=(1, 7))
    assert p.users.array is before and p.step == 1
    assert out.user_updates == [] and out.item_updates == []
    assert out.user_arrays[1].shape == (0, RANK)
    assert p.partial_fit(Ratings.from_arrays([], [], []),
                         emit_updates=False, offset=(0, 12)) is None
    assert p.consumed_offsets == {0: 12, 1: 7} and p.step == 1


def test_snapshots_survive_later_batches_and_to_model_serves_like_live():
    j, p = _pair(lr=0.1)
    batches = _batches(6, n=500, seed=2)
    for b in batches[:3]:
        p.partial_fit(_port(b), emit_updates=False)
        j.partial_fit(b, emit_updates=False)
    snap = p.users.array
    before = snap.clone()
    model = p.to_model()
    jmodel = j.to_model()
    U_before = model.U.clone()
    te = _batches(1, n=400, seed=9)[0]
    ru, ri, _, _ = te.to_numpy()
    s_live, seen_live = p.predict(ru, ri, return_mask=True)
    s_snap, seen_snap = model.predict(ru, ri, return_mask=True)
    np.testing.assert_array_equal(seen_live, seen_snap)
    np.testing.assert_array_equal(s_live, s_snap)
    assert abs(p.rmse(_port(te)) - model.rmse(_port(te))) < 1e-6
    js, jseen = jmodel.predict(ru, ri, return_mask=True)
    np.testing.assert_array_equal(seen_snap, np.asarray(jseen))
    np.testing.assert_allclose(s_snap, np.asarray(js), **TOL)
    assert abs(p.rmse(_port(te)) - j.rmse(te)) < 1e-5
    for b in batches[3:]:
        p.partial_fit(_port(b))
    assert torch.equal(snap, before) and torch.equal(model.U, U_before)
    assert not torch.equal(p.users.array[:len(before)], before)
    ids, scores = model.recommend(model.users.sorted_ids[:5], k=5)
    assert (ids >= 0).all() and (np.diff(scores, axis=1) <= 0).all()


def test_empty_model_and_unseen_ids():
    _, p = _pair()
    model = p.to_model()
    s, seen = model.predict(np.array([1, 7]), np.array([2, 9]),
                            return_mask=True)
    assert (s == 0).all() and not seen.any()
    assert np.isnan(p.rmse(Ratings.from_arrays([1], [2], [3.0])))
    p.partial_fit(Ratings.from_arrays([1], [2], [3.0]))
    s = p.predict([1, 99], [2, 2])
    assert s[1] == 0.0 and s[0] != 0.0


def test_minibatch1_matches_sequential_numpy_sgd():
    rng = np.random.default_rng(0)
    n = 40
    users = rng.integers(0, 5, n)
    items = rng.integers(0, 6, n)
    vals = rng.normal(0, 1, n).astype(np.float32)
    lr = 0.05
    _, pinit = _inits(3)
    m = OnlineMF(OnlineMFConfig(num_factors=3, learning_rate=lr,
                                minibatch_size=1), user_initializer=pinit,
                 item_initializer=pinit, device="cpu")
    m.partial_fit(Ratings.from_arrays(users, items, vals))
    U = {i: _INIT[i, :3].astype(np.float64) for i in set(users.tolist())}
    V = {i: _INIT[i, :3].astype(np.float64) for i in set(items.tolist())}
    for u, i, r in zip(users, items, vals):
        e = r - U[u] @ V[i]
        U[u], V[i] = U[u] + lr * e * V[i], V[i] + lr * e * U[u]
    got = m.user_factors()
    for i in U:
        np.testing.assert_allclose(got[i], U[i], rtol=1e-4, atol=1e-5)
    assert set(m.item_factors()) == set(V)


def test_run_and_pluggable_updater():
    _, p = _pair()
    outs = list(p.run(_port(b) for b in _batches(3, n=50)))
    assert len(outs) == 3 and all(isinstance(o, BatchUpdates) for o in outs)
    assert p.step == 3
    m = OnlineMF(OnlineMFConfig(num_factors=4, minibatch_size=8),
                 updater=SGDUpdater(learning_rate=0.0), device="cpu")
    out = m.partial_fit(Ratings.from_arrays([1], [2], [3.0]))
    want = PseudoRandomFactorInitializer(4, scale=0.1)(np.array([1]))[0]
    np.testing.assert_array_equal(out.user_updates[0].vector.factors,
                                  want.numpy())


def test_watchdog_runs_before_the_offset_stamp():
    _, p = _pair()
    seen = []

    class Trip:
        def after_batch(self, model, U, V, u_rows, i_rows):
            seen.append(dict(model.consumed_offsets))
            raise RuntimeError("tripped")

    p.watchdog = Trip()
    with pytest.raises(RuntimeError, match="tripped"):
        p.partial_fit(_port(_batches(1, n=20)[0]), offset=(0, 5))
    assert seen == [{}] and p.consumed_offsets == {}


def test_online_from_jax_carries_the_state():
    j, _ = _pair(capacity=8)
    batches = _batches(5, seed=4)
    for k, b in enumerate(batches[:2]):
        j.partial_fit(b, offset=(0, k + 1))
    _, pinit = _inits()
    p = convert.online_from_jax(j, device="cpu", user_initializer=pinit,
                                item_initializer=pinit)
    assert p.config == OnlineMFConfig(**{
        f: getattr(j.config, f) for f in OnlineMFConfig.__dataclass_fields__})
    assert p.consumed_offsets == {0: 2}
    for pt, jt in ((p.users, j.users), (p.items, j.items)):
        _assert_same_table(pt, jt)
    for b in batches[2:]:
        j.partial_fit(b)
        p.partial_fit(_port(b))
        _assert_close_model(p, j)


def test_batch_updates_builds_both_ways_like_jax():
    """``BatchUpdates`` takes the JAX signature: object lists positional,
    arrays and rank keyword-only (``models/adaptive.py:228`` builds it from
    lists with ``rank=``), each form derived from the other on read, an
    empty side shaped ``(0, rank)``."""
    from large_scale_recommendation_tpu.core.types import (
        FactorVector as JVec,
    )
    from large_scale_recommendation_tpu.core.types import (
        UserUpdate as JUserUpdate,
    )
    from large_scale_recommendation_tpu.models.online import (
        BatchUpdates as JBatchUpdates,
    )

    vecs = np.arange(6, dtype=np.float32).reshape(2, 3)
    users = [UserUpdate(FactorVector(7, vecs[0])),
             UserUpdate(FactorVector(9, vecs[1]))]
    jusers = [JUserUpdate(JVec(7, vecs[0])), JUserUpdate(JVec(9, vecs[1]))]
    t = BatchUpdates(users, [], rank=3)
    j = JBatchUpdates(jusers, [], rank=3)
    for side in ("user_arrays", "item_arrays"):
        (ti, tv), (ji, jv) = getattr(t, side), getattr(j, side)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        assert ti.dtype == np.int64 and tv.dtype == np.float32
    assert t.item_arrays[1].shape == (0, 3)
    assert list(t) == users
    a = BatchUpdates(user_arrays=(np.array([7, 9]), vecs),
                     item_arrays=(np.zeros(0, np.int64),
                                  np.zeros((0, 3), np.float32)), rank=3)
    assert [u.vector.id for u in a.user_updates] == [7, 9]
    np.testing.assert_array_equal(a.user_updates[1].vector.factors, vecs[1])
    assert a.item_updates == []
    with pytest.raises(TypeError):
        BatchUpdates(users, [], 3)  # rank is keyword-only


# -- the obs hooks -----------------------------------------------------------


@pytest.fixture
def planes():
    """Live registries, event journals and transfer ledgers in both
    packages (the hooks bind at construction: build models inside); each
    package's defaults restored after."""
    from large_scale_recommendation_tpu import obs as jobs
    from large_scale_recommendation_tpu.obs import events as jev
    from large_scale_recommendation_tpu.obs import transfers as jtx
    from large_scale_recommendation_tpu_torch import obs

    jprev = (jobs.get_registry(), jobs.get_tracer(), jobs.get_events(),
             jtx.get_transfers())
    pprev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
             obs.get_transfers())
    jreg, _ = jobs.enable()
    jev.set_events(jev.EventJournal())
    jled = jobs.enable_transfers(watch_hot=False)
    preg, _ = obs.enable()
    obs.set_events(obs.EventJournal())
    pled = obs.enable_transfers(watch_hot=False)
    yield ((jreg, jev.get_events(), jled),
           (preg, obs.get_events(), pled))
    jobs.disable()
    jobs.set_registry(jprev[0])
    jobs.set_tracer(jprev[1])
    jev.set_events(jprev[2])
    jtx.set_transfers(jprev[3])
    obs.disable()
    obs.set_registry(pprev[0])
    obs.set_tracer(pprev[1])
    obs.set_events(pprev[2])
    obs.set_transfers(pprev[3])


def _hooks_off_tables(concurrent, batches, **kw):
    """The port's tables after each batch with every obs plane off."""
    from large_scale_recommendation_tpu_torch import obs

    state = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
             obs.get_transfers())
    obs.disable()
    try:
        _, p = _pair(**kw)
        assert p._obs_on is False and p._events is None
        if concurrent:
            p.enable_concurrent_applies()
        out = []
        for n, b in enumerate(batches, start=1):
            p.partial_fit(_port(b), emit_updates=n % 2 == 1)
            out.append((p.users.array, p.items.array))
        return out
    finally:
        obs.set_registry(state[0])
        obs.set_tracer(state[1])
        obs.set_events(state[2])
        obs.set_transfers(state[3])


def _growth(journal):
    return [tuple(e["detail"][k] for k in ("step", "users_capacity",
                                           "items_capacity"))
            for e in journal.events("online.table_growth")]


def _sites(ledger):
    return {name: {k: v for k, v in site.items()
                   if k in ("h2d_bytes", "d2h_bytes", "h2d_count",
                            "d2h_count")}
            for name, site in ledger.snapshot()["sites"].items()}


@pytest.mark.parametrize("concurrent", [False, True])
def test_obs_hooks_match_jax_on_a_growing_table(planes, monkeypatch,
                                                concurrent):
    """Hooks on against off (the port, bit-equal tables) and against the
    JAX hooks on the same numpy inputs: the tables at the file's bar, the
    histogram's count and both counters after every batch, the growth
    events' capacities, the staging and emit notes' bytes; the
    ``online.partial_fit`` guard is entered once per batch (the scope is
    read when the batch runs, whatever the plane was at construction)."""
    from large_scale_recommendation_tpu_torch.models import online as pmod

    (jreg, jjournal, jled), (preg, pjournal, pled) = planes
    batches = _batches(5, n=300, seed=6)
    off = _hooks_off_tables(concurrent, batches, capacity=16)
    j, p = _pair(capacity=16)
    if concurrent:
        j.enable_concurrent_applies()
        p.enable_concurrent_applies()
    guarded = []
    real_guard = pmod.guard_scope
    monkeypatch.setattr(pmod, "guard_scope",
                        lambda site: guarded.append(site) or real_guard(site))
    ratings = 0
    for n, (b, tables_off) in enumerate(zip(batches, off), start=1):
        emit = n % 2 == 1
        ju = j.partial_fit(b, emit_updates=emit)
        pu = p.partial_fit(_port(b), emit_updates=emit)
        ratings += b.n
        assert torch.equal(p.users.array, tables_off[0])
        assert torch.equal(p.items.array, tables_off[1])
        _assert_close_model(p, j)
        if emit:
            for side in ("user_arrays", "item_arrays"):
                np.testing.assert_array_equal(getattr(pu, side)[0],
                                              getattr(ju, side)[0])
        assert preg.histogram("online_batch_s").count == n == \
            jreg.histogram("online_batch_s").count
        for name, want in (("online_batches_total", n),
                           ("online_ratings_total", ratings)):
            assert preg.counter(name).value == want == \
                jreg.counter(name).value
    assert guarded == ["online.partial_fit"] * 5
    grew = _growth(pjournal)
    assert grew and grew == _growth(jjournal)
    assert grew[-1][1:] == (p.users.capacity, p.items.capacity)
    sites = _sites(pled)
    assert sites == _sites(jled)
    assert sites["online.minibatch_stage"]["h2d_count"] == 5
    assert sites["online.emit_updates"]["d2h_count"] == 3


def test_batch_wait_runs_outside_the_apply_lock(planes, monkeypatch):
    """On the concurrent path the batch histogram's wait comes after
    ``apply_lock`` is released: while it runs, another thread takes and
    holds the lock."""
    import threading

    from large_scale_recommendation_tpu_torch.models import online as pmod

    _, p = _pair(capacity=16)
    p.enable_concurrent_applies()
    held = []

    def wait(done):
        taken, release = threading.Event(), threading.Event()

        def other():
            if p.apply_lock.acquire(timeout=5.0):
                taken.set()
                release.wait(5.0)
                p.apply_lock.release()

        t = threading.Thread(target=other)
        t.start()
        held.append(taken.wait(5.0))
        release.set()
        t.join(5.0)
        assert not t.is_alive()

    monkeypatch.setattr(pmod, "_wait", wait)
    for b in _batches(3, n=200, seed=8):
        p.partial_fit(_port(b), emit_updates=False)
    assert held == [True, True, True]
