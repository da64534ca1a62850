"""``AdaptiveMF``'s device route (``DeviceAdaptiveMFConfig``:
a history ring in the online tables' row space, ``DSGD.fit_device``
retrains, installs by row) against the benchmark's plain reference
(``portbench/reference/adaptive.py`` with ``reference/online.py`` and
``reference/dsgd.py``, plain torch that imports nothing of the port), on
the CPU, over seeded batches: three retrain cycles with a window that
slides, cuts a batch in two and leaves some registered ids out.

Bars: the tables after each swap and at the end within rtol 1e-5 / atol
1e-6. Both sides run the same f32 operations in the same order on the
CPU (the plain DSGD route against ``reference/dsgd.py``'s steps, the
online step against ``reference/online.py``'s), so they agree to a few
ulps at most; a retrain's structure (its layout, schedule or init) or an
install of the wrong rows moves them by far more."""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.adaptive import (
    AdaptiveMF,
    DeviceAdaptiveMFConfig,
)
from large_scale_recommendation_tpu_torch.models.dsgd import DSGDConfig
from portbench.reference import adaptive as ref_adaptive
from portbench.reference.keyed import keyed_rows
from portbench.reference.online import OnlineSGD

RANK, LR, MB = 8, 0.05, 128
USERS, ITEMS = 300, 120  # id ranges; some ids never arrive
BATCH, BATCHES, EVERY, LIMIT = 500, 9, 3, 1200
INIT = 0.1  # the online tables' keyed init (OnlineMFConfig's default)
DSGD = dict(num_factors=RANK, lambda_=0.1, iterations=3, learning_rate=0.05,
            lr_schedule="warm_boost", minibatch_size=64, init_scale=0.08,
            collision_mode="mean", minibatch_sort="item",
            factor_dtype="float32", num_blocks=2, seed=7)
BAR = dict(rtol=1e-5, atol=1e-6)


def _config(**kw):
    return DeviceAdaptiveMFConfig(
        num_factors=RANK, learning_rate=LR, minibatch_size=MB,
        offline_every=EVERY, history_limit=LIMIT,
        retrain=DSGDConfig(**DSGD), **kw)


def _stream(seed=0):
    """Seeded ratings with skewed ids (the low ids hot): int64 ids, f32
    ratings, ``BATCHES`` batches of ``BATCH`` in arrival order."""
    rng = np.random.default_rng(seed)
    n = BATCH * BATCHES
    u = np.minimum(rng.exponential(USERS / 3, n), USERS - 1).astype(np.int64)
    i = np.minimum(rng.exponential(ITEMS / 3, n), ITEMS - 1).astype(np.int64)
    r = rng.normal(0.0, 1.0, n).astype(np.float32)
    return u, i, r


def _batch(stream, b):
    sl = slice(b * BATCH, (b + 1) * BATCH)
    return Ratings.from_arrays(*(a[sl] for a in stream))


class _Reference:
    """The plain adaptive model on dense rows numbered as the ids first
    arrive (the program's tables' rows)."""

    def __init__(self, stream):
        self.stream = stream
        u, i, r = (torch.from_numpy(a) for a in stream)
        (self.row_u, self.id_u), (self.row_i, self.id_i) = (
            ref_adaptive.first_seen_rows(u, USERS),
            ref_adaptive.first_seen_rows(i, ITEMS))
        self.u, self.i, self.r = self.row_u[u], self.row_i[i], r
        self.online = OnlineSGD(len(self.id_u), len(self.id_i), RANK, lr=LR,
                                minibatch=MB, init_scale=INIT, device="cpu")
        # a row starts as its id's keyed row
        self.online.U = keyed_rows(self.id_u, RANK, INIT)
        self.online.V = keyed_rows(self.id_i, RANK, INIT)
        self.fed = 0

    def window(self):
        sl = slice(max(0, self.fed - LIMIT), self.fed)
        return self.u[sl], self.i[sl], self.r[sl]

    def process(self, b):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        self.online.batch(self.u[sl], self.i[sl], self.r[sl])
        self.fed = (b + 1) * BATCH
        if (b + 1) % EVERY == 0:
            self.retrain()

    def retrain(self):
        u, i, r = self.window()
        # the rows registered so far: the distinct ids fed
        nu, ni = (len(np.unique(a[:self.fed])) for a in self.stream[:2])
        lay, U, V = ref_adaptive.retrain(u, i, r, nu, ni, DSGD, DSGD["seed"])
        on = self.online
        for side, name, T, row_of in (("users", "U", U, lay.row_of_user),
                                      ("items", "V", V, lay.row_of_item)):
            ids = ref_adaptive.window_rows(lay, side)
            setattr(on, name, ref_adaptive.install(getattr(on, name), ids,
                                                   row_of[ids], T))


def _assert_tables(model, ref):
    for table, want, id_of in ((model.online.users, ref.online.U, ref.id_u),
                               (model.online.items, ref.online.V, ref.id_i)):
        n = table.num_rows
        np.testing.assert_array_equal(table.id_array(), id_of[:n].numpy())
        np.testing.assert_allclose(table.array[:n].numpy(),
                                   want[:n].numpy(), **BAR)


def _run(model, stream, after=None):
    ref = _Reference(stream)
    swaps = 0
    for b in range(BATCHES):
        before = (model.online.users.array, model.online.items.array)
        model.process(_batch(stream, b))
        ref.process(b)
        if model.retrain_count != swaps:
            swaps = model.retrain_count
            if after is not None:
                after(model, ref, before)
            _assert_tables(model, ref)
    _assert_tables(model, ref)
    return ref


def test_device_route_matches_the_plain_reference():
    model = AdaptiveMF(_config(), device="cpu")
    _run(model, _stream())
    assert model.retrain_count == BATCHES // EVERY


def test_ids_outside_the_window_keep_their_rows():
    kept = []

    def after(model, ref, before):
        u, i, _ = ref.window()
        for table, old, rows in ((model.online.users, before[0], u),
                                 (model.online.items, before[1], i)):
            out = np.setdiff1d(np.arange(table.num_rows), rows.numpy())
            kept.append(len(out))
            # the swap's batch is inside the window: the online step of
            # that call never touched these rows either
            torch.testing.assert_close(table.array[out], old[out],
                                       rtol=0, atol=0)

    _run(AdaptiveMF(_config(), device="cpu"), _stream(1), after)
    assert sum(kept) > 0


def test_the_ring_keeps_exactly_the_newest_ratings():
    stream = _stream(2)
    model = AdaptiveMF(DeviceAdaptiveMFConfig(
        num_factors=RANK, offline_every=None, history_limit=LIMIT,
        retrain=DSGDConfig(**DSGD)), device="cpu")
    ref = _Reference(stream)
    for b in range(BATCHES):
        model.preload_history(_batch(stream, b))
        ref.fed = (b + 1) * BATCH
        u, i, r, nu, ni = model._history_window()
        want = ref.window()
        assert len(u) == min(ref.fed, LIMIT) == model._history_rows
        for got, w in zip((u, i, r), want):
            torch.testing.assert_close(got.to(w.dtype), w, rtol=0, atol=0)
        assert (nu, ni) == (model.online.users.num_rows,
                            model.online.items.num_rows)
    # the preload registered every id it saw, in first-seen order, with
    # no gradient step: each row is its id's keyed row
    _assert_tables(model, ref)
    model.clear_history()
    assert model._history_rows == 0
    model.preload_history(_batch(stream, 0))
    torch.testing.assert_close(model._history_window()[0],
                               ref.u[:BATCH].to(torch.int32))


def test_a_background_retrain_flushed_at_once_equals_the_synchronous():
    model = AdaptiveMF(_config(background=True), device="cpu")
    stream = _stream(3)
    ref = _Reference(stream)
    for b in range(BATCHES):
        assert model.process(_batch(stream, b), emit_updates=False) is None
        ref.process(b)
        if model.state == "Batch":
            model.flush()
            _assert_tables(model, ref)
    assert model.retrain_count == BATCHES // EVERY


def test_process_emits_updates_unless_ingesting():
    model = AdaptiveMF(_config(), device="cpu")
    stream = _stream(4)
    out = model.process(_batch(stream, 0))
    ids, vecs = out.user_arrays
    np.testing.assert_array_equal(ids, np.unique(stream[0][:BATCH]))
    assert vecs.shape == (len(ids), RANK)
    assert model.process(_batch(stream, 1), emit_updates=False) is None


@pytest.mark.parametrize("kw", [dict(history_limit=None),
                                dict(offline_algorithm="als")])
def test_the_device_route_needs_dsgd_and_a_ring_size(kw):
    with pytest.raises(ValueError, match="device route"):
        AdaptiveMF(DeviceAdaptiveMFConfig(
            num_factors=RANK, retrain=DSGDConfig(**DSGD),
            **{"history_limit": LIMIT, **kw}), device="cpu")
