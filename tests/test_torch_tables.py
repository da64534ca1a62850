"""The port's ``GrowableFactorTable`` id lookup (``data.tables``): a dense
direct-address map while every registered id lies in ``[0, 8 ×
capacity)``, the sorted index once one does not.

Each id stream is held against a plain getOrElseUpdate dict (rows, found
masks, ``id_array()`` order, ``sorted_index()``), against the JAX
package's table on the CPU (rows, capacities, arrays), across re-indexing
(a JAX table or tiered store adopted by ``convert``, a checkpoint
restore), and the ``direct`` counter of ``online/ensure.lookup``.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.initializers import (
    FunctionFactorInitializer as JFunctionInit,
)
from large_scale_recommendation_tpu.data.tables import (
    GrowableFactorTable as JTable,
)
from large_scale_recommendation_tpu.store.tiered import (
    TieredFactorStore as JTiered,
)
from large_scale_recommendation_tpu_torch import convert, obs
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data.tables import (
    GrowableFactorTable,
    HostFactorTable,
)
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_online_state,
    save_online_state,
)

RANK = 4
_ROWS = 4096
_INIT = np.random.default_rng(7).uniform(
    -0.3, 0.3, (_ROWS, RANK)).astype(np.float32)


def _init_rows(ids) -> np.ndarray:
    """The rows both packages' initializers give ``ids`` (any int64)."""
    return _INIT[np.asarray(ids, np.int64) % _ROWS]


def _pinit():
    return FunctionFactorInitializer(
        RANK, lambda ids: torch.from_numpy(_init_rows(ids.cpu().numpy())))


def _jinit():
    return JFunctionInit(RANK, lambda ids: jnp.asarray(_init_rows(ids)))


def _rand(seed, lo, hi, n):
    return np.random.default_rng(seed).integers(lo, hi, n).tolist()


# name → (capacity, batches, whether the dense map still answers at the end)
STREAMS = {
    "dense": (16, [_rand(1, 0, 100, 40), _rand(2, 0, 100, 60),
                   _rand(3, 0, 120, 80)], True),
    "negative": (16, [[5, -3, 5, 9], _rand(4, -50, 50, 40), [-3, 7, 11]],
                 False),
    "sparse": (16, [_rand(5, 10**6, 10**12, 30), [128, 3, 128],
                    _rand(6, 10**6, 10**12, 30)], False),
    "crossing": (16, [_rand(7, 0, 100, 50), _rand(8, 0, 100, 50),
                      [3, 5000, 4, 5000], _rand(9, 0, 200, 60), [6000, 1]],
                 False),
    "growing": (8, [list(range(6)), list(range(60)), list(range(60, 700)),
                    [3000, 2, 3000, 8191], _rand(10, 0, 9000, 200)], True),
}

PROBE = [0, 1, 97, 127, 128, 5000, 8191, 8192, -1, -3, 10**13]


def _check_against(table, oracle: dict, probe) -> None:
    np.testing.assert_array_equal(table.id_array(),
                                  np.asarray(list(oracle), np.int64))
    probe = np.asarray(probe, np.int64)
    rows, found = table.rows_for(probe)
    assert rows.dtype == np.int64 and found.dtype == np.float32
    np.testing.assert_array_equal(
        rows, [oracle.get(int(i), 0) for i in probe])
    np.testing.assert_array_equal(
        found, [float(int(i) in oracle) for i in probe])


@pytest.mark.parametrize("watch_index", [False, True])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_rows_follow_a_getorelseupdate_dict(name, watch_index):
    """Rows, masks and row order are a sequential getOrElseUpdate's on
    either path; ``sorted_index()`` is the argsort of ``id_array()``,
    built lazily at the end or kept up to date by every merge."""
    capacity, batches, dense = STREAMS[name]
    table = GrowableFactorTable(_pinit(), capacity=capacity, device="cpu")
    oracle: dict[int, int] = {}
    for batch in batches:
        want = [oracle.setdefault(int(i), len(oracle)) for i in batch]
        got = table.ensure(np.asarray(batch))
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        _check_against(table, oracle, PROBE + batch)
        np.testing.assert_array_equal(table.array[:table.num_rows].numpy(),
                                      _init_rows(table.id_array()))
        if watch_index:
            table.sorted_index()
    assert (table._row_of is not None) is dense
    ids = table.id_array()
    order = np.argsort(ids)
    s_ids, s_rows = table.sorted_index()
    np.testing.assert_array_equal(s_ids, ids[order])
    np.testing.assert_array_equal(s_rows, order)


def test_host_table_inherits_the_map():
    table = HostFactorTable(_pinit(), capacity=8)
    oracle: dict[int, int] = {}
    for batch in STREAMS["growing"][1]:
        want = [oracle.setdefault(int(i), len(oracle)) for i in batch]
        np.testing.assert_array_equal(table.ensure(np.asarray(batch)), want)
    assert table._row_of is not None
    _check_against(table, oracle, PROBE)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_rows_and_arrays_match_the_jax_table(name):
    """The dense path and the sorted one give every id the JAX package's
    row, capacity, sorted index and initial values, bit for bit."""
    capacity, batches, _ = STREAMS[name]
    jt = JTable(_jinit(), capacity=capacity)
    pt = GrowableFactorTable(_pinit(), capacity=capacity, device="cpu")
    for batch in batches:
        ids = np.asarray(batch)
        np.testing.assert_array_equal(pt.ensure(ids), jt.ensure(ids))
        assert pt.capacity == jt.capacity
        np.testing.assert_array_equal(pt.id_array(), jt.id_array())
        np.testing.assert_array_equal(pt.array.numpy(), np.asarray(jt.array))
    probe = np.asarray(PROBE, np.int64)
    for a, b in zip(pt.rows_for(probe), jt.rows_for(probe)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt.sorted_index(), jt.sorted_index()):
        np.testing.assert_array_equal(a, b)


def test_readers_see_every_registered_id_while_the_map_grows():
    """``rows_for`` from many threads while one thread registers ids and
    grows the table and its map: every id registered before a read began
    is found at its row (a grown map is filled before it is bound)."""
    table = GrowableFactorTable(_pinit(), capacity=8, device="cpu")
    published = [0]  # ids [0, n) are registered, id i at row i
    done = threading.Event()
    errors: list[str] = []

    def write():
        try:
            for a in range(0, 6000, 50):
                table.ensure(np.arange(a, a + 50))
                published[0] = a + 50
        finally:
            done.set()

    def read(seed):
        rng = np.random.default_rng(seed)
        while not done.is_set() and not errors:
            n = published[0]
            if n == 0:
                continue
            probe = rng.integers(0, n, 64)
            rows, found = table.rows_for(probe)
            if not (found.all() and np.array_equal(rows, probe)):
                errors.append(f"ids below {n} misread")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(s,))
                   for s in range((os.cpu_count() or 1) + 1)]
        threads.append(threading.Thread(target=write))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert table.num_rows == 6000 and table._row_of is not None


# -- re-indexing ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_adopted_table_answers_through_its_own_lookup(name):
    """``convert._adopt_table`` rewrites a port table's ids: its lookup is
    rebuilt from them (the map on a dense table), before and after ids
    registered later."""
    capacity, batches, dense = STREAMS[name]
    jt = JTable(_jinit(), capacity=capacity)
    for batch in batches[:2]:
        jt.ensure(np.asarray(batch))
    pt = GrowableFactorTable(_pinit(), capacity=8, device="cpu")
    pt.ensure(np.asarray([999_999, 5]))  # a state the adoption replaces
    convert._adopt_table(pt, jt, "cpu")
    assert (pt._row_of is not None) is dense
    probe = np.asarray(PROBE + batches[0], np.int64)
    for a, b in zip(pt.rows_for(probe), jt.rows_for(probe)):
        np.testing.assert_array_equal(a, b)
    ids = np.asarray(batches[2] + [999_999])
    np.testing.assert_array_equal(pt.ensure(ids), jt.ensure(ids))
    for a, b in zip(pt.rows_for(probe), jt.rows_for(probe)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt.array.numpy(), np.asarray(jt.array))


def test_adopted_tiered_store_answers_through_the_map():
    jst = JTiered(_jinit(), capacity=16, slot_capacity=8)
    oracle: dict[int, int] = {}
    for batch in STREAMS["dense"][1][:2]:
        for i in batch:
            oracle.setdefault(int(i), len(oracle))
        jst.ensure(np.asarray(batch))
    st = convert.tiered_store_from_jax(jst, device="cpu",
                                       initializer=_pinit())
    assert st._row_of is not None
    _check_against(st, oracle, PROBE)
    batch = STREAMS["dense"][1][2] + [3000]
    want = [oracle.setdefault(int(i), len(oracle)) for i in batch]
    np.testing.assert_array_equal(st.ensure(np.asarray(batch)), want)
    np.testing.assert_array_equal(st.ensure(np.asarray(batch)),
                                  jst.ensure(np.asarray(batch)))
    _check_against(st, oracle, PROBE)


def _ratings(seed, users, items, n):
    rng = np.random.default_rng(seed)
    return Ratings(rng.integers(*users, n).astype(np.int32),
                   rng.integers(*items, n).astype(np.int32),
                   rng.random(n).astype(np.float32), np.ones(n, np.float32))


def test_restored_tables_answer_through_the_map(tmp_path):
    """A checkpoint restore registers the saved ids in order: the restored
    tables answer through the map, and ids registered after the restore
    get the rows the saved model gives them."""
    cfg = OnlineMFConfig(num_factors=RANK, minibatch_size=64,
                         init_capacity=16)
    saved = OnlineMF(cfg, device="cpu")
    for seed in (1, 2):
        saved.partial_fit(_ratings(seed, (0, 90), (0, 40), 300),
                          emit_updates=False)
    mgr = CheckpointManager(str(tmp_path))
    save_online_state(mgr, saved, step=2)
    restored = OnlineMF(cfg, device="cpu")
    restore_online_state(mgr, restored)
    later = _ratings(3, (0, 200), (0, 80), 300)
    for model in (saved, restored):
        model.partial_fit(later, emit_updates=False)
    for side in ("users", "items"):
        s, r = getattr(saved, side), getattr(restored, side)
        assert r._row_of is not None
        np.testing.assert_array_equal(r.id_array(), s.id_array())
        probe = np.asarray(PROBE + list(range(200)), np.int64)
        for a, b in zip(r.rows_for(probe), s.rows_for(probe)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r.array[:r.num_rows].numpy(),
                                      s.array[:s.num_rows].numpy())


# -- the lookup's counter -------------------------------------------------------


@pytest.fixture
def span_table():
    prev = obs.get_tracer()
    obs.set_tracer(ptr.NULL_TRACER)
    ptr.reset_span_totals()
    yield
    obs.set_tracer(prev)
    ptr.reset_span_totals()


@pytest.mark.parametrize("name", ["dense", "sparse", "crossing"])
def test_lookup_counts_the_ids_the_map_resolved(span_table, name):
    """``online/ensure.lookup`` notes ``direct``: a batch's id count while
    the map answers (the batch that crosses the bound is still looked up
    through it), 0 once the sorted index does."""
    capacity, batches, _ = STREAMS[name]
    table = GrowableFactorTable(_pinit(), capacity=capacity, device="cpu")
    for batch in batches:
        dense = table._row_of is not None
        ptr.reset_span_totals()
        with profile(activities=[ProfilerActivity.CPU]):
            table.ensure(np.asarray(batch))
        tot = ptr.span_totals()
        assert tot["online/ensure"]["args"]["ids"] == len(batch)
        lookup = tot["online/ensure.lookup"]
        assert lookup["count"] == 1
        assert lookup["args"]["direct"] == (len(batch) if dense else 0)
