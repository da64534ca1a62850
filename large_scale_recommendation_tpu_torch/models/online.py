"""Online (streaming) matrix factorization on growable tables (counterpart
of ``large_scale_recommendation_tpu.models.online``).

Each micro-batch is one gather → update → scatter pass
(``ops.sgd.online_train``, torch ops on the tables' device) over the
batch's ratings, on ``data.tables.GrowableFactorTable``s that register
unseen ids on the way in. ``partial_fit`` returns the updates-only output:
exactly the user and item vectors the batch touched.

``enable_concurrent_applies(True)`` routes ``partial_fit`` through the
concurrent-apply twin (``streams.parallel.ParallelIngestRunner`` arms it for
N > 1 consumers): table mutation serializes on ``apply_lock``, the update
computes on a snapshot outside it, and the commit writes back only the
batch's touched rows. A snapshot is two tensor references: a table is never
written in place (``data/tables.py``). Every consumer thread enqueues on the
default CUDA stream, so the card runs the work in the order it was enqueued
under the lock. ``watchdog`` is the divergence seam, ``None`` by default.

The obs hooks keep the JAX names and bind at construction (the null
registry's shared instruments when obs is off: no clock read, no wait):

- ``apply_lock`` is the contention plane's ``online.apply_lock``;
- each update is an ``online/partial_fit`` span (compile-keyed on the
  padded batch length), its ``online_train`` call inside
  ``guard_scope("online.partial_fit")`` — the staging before it is an
  explicit host→device copy and stays outside the guard;
- with the transfer ledger installed, the staged bytes are noted at
  ``online.minibatch_stage`` (h2d, with ``observe_call("online_train",
  …)``) and the updates-only pull at ``online.emit_updates`` (d2h, with
  its wait);
- with an event journal, a batch that grew a table emits
  ``online.table_growth`` (on the concurrent path detected under
  ``apply_lock`` and emitted after it);
- with obs on, ``online_batch_s`` observes each batch's wall up to its last
  write on its stream (an event waited on, after ``apply_lock`` is
  released on the concurrent path), and ``online_batches_total`` /
  ``online_ratings_total`` count the batches and ratings applied.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.limiter import ThroughputLimiter
from large_scale_recommendation_tpu_torch.core.types import (
    FactorVector,
    ItemUpdate,
    Ratings,
    UserUpdate,
)
from large_scale_recommendation_tpu_torch.core.updaters import SGDUpdater
from large_scale_recommendation_tpu_torch.data.blocking import flat_index
from large_scale_recommendation_tpu_torch.data.tables import (
    GrowableFactorTable,
)
from large_scale_recommendation_tpu_torch.models.mf import MFModel, masked_scores
from large_scale_recommendation_tpu_torch.obs.contention import named_rlock
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer
from large_scale_recommendation_tpu_torch.obs.transfers import (
    get_transfers,
    guard_scope,
)
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.utils.device import resolve_device
from large_scale_recommendation_tpu_torch.utils.shapes import pow2_pad


@dataclasses.dataclass(frozen=True)
class OnlineMFConfig:
    """Defaults: plain unregularized SGD, one iteration per micro-batch,
    rank 10."""

    num_factors: int = 10
    learning_rate: float = 0.01
    iterations_per_batch: int = 1
    minibatch_size: int = 256
    init_capacity: int = 1024
    init_scale: float = 0.1
    collision_mode: str = "mean"  # minibatch row-collision handling (ops.sgd)


class BatchUpdates:
    """Updates-only output of one micro-batch: the touched vectors.

    Built either from the per-row ``UserUpdate``/``ItemUpdate`` lists
    (positional) or, on the hot path, from arrays (``user_arrays=`` /
    ``item_arrays=``: ids int64[n], vectors float32[n, k], one bulk device
    pull per side); each form is derived from the other only when read.
    An empty side's vectors have shape ``(0, rank)``."""

    def __init__(self, user_updates=None, item_updates=None, *,
                 user_arrays: tuple[np.ndarray, np.ndarray] | None = None,
                 item_arrays: tuple[np.ndarray, np.ndarray] | None = None,
                 rank: int | None = None):
        self._user_list = user_updates
        self._item_list = item_updates
        self._user_arrays = user_arrays
        self._item_arrays = item_arrays
        self._rank = rank

    def _as_arrays(self, ups):
        ids = np.asarray([u.vector.id for u in ups], dtype=np.int64)
        if ups:
            return ids, np.stack([u.vector.factors for u in ups])
        return ids, np.zeros((0, self._rank or 0), np.float32)

    @property
    def user_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        if self._user_arrays is None:
            self._user_arrays = self._as_arrays(self._user_list or [])
        return self._user_arrays

    @property
    def item_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        if self._item_arrays is None:
            self._item_arrays = self._as_arrays(self._item_list or [])
        return self._item_arrays

    @staticmethod
    def _as_list(arrays, cls):
        ids, vecs = arrays
        return [cls(FactorVector(int(i), vecs[j]))
                for j, i in enumerate(ids.tolist())]

    @property
    def user_updates(self) -> list[UserUpdate]:
        if self._user_list is None:
            self._user_list = self._as_list(self._user_arrays, UserUpdate)
        return self._user_list

    @property
    def item_updates(self) -> list[ItemUpdate]:
        if self._item_list is None:
            self._item_list = self._as_list(self._item_arrays, ItemUpdate)
        return self._item_list

    def __iter__(self):
        yield from self.user_updates
        yield from self.item_updates


def _batch_done(out: torch.Tensor):
    """A marker of a batch's last write: an event recorded now on the
    current stream of ``out``'s card (not a device-wide sync: other
    threads' streams are not waited for), or ``None`` for a CPU tensor,
    whose work is done when the call returns."""
    if out.device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return done


def _wait(done) -> None:
    """Wait for a ``_batch_done`` marker."""
    if done is not None:
        done.synchronize()


class OnlineMF:
    """Streaming MF on growable tables: construct with pluggable
    initializers and updater, then feed micro-batches (``partial_fit``) or
    a paced stream (``run``). ``device=None`` runs on the card."""

    def __init__(
        self,
        config: OnlineMFConfig | None = None,
        updater: Any = None,
        user_initializer: Any = None,
        item_initializer: Any = None,
        device=None,
    ):
        self.config = cfg = config or OnlineMFConfig()
        self.device = resolve_device(device)
        self.updater = updater or SGDUpdater(learning_rate=cfg.learning_rate)
        init_u = user_initializer or PseudoRandomFactorInitializer(
            cfg.num_factors, scale=cfg.init_scale)
        init_v = item_initializer or PseudoRandomFactorInitializer(
            cfg.num_factors, scale=cfg.init_scale)
        self.users = GrowableFactorTable(init_u, capacity=cfg.init_capacity,
                                         device=self.device)
        self.items = GrowableFactorTable(init_v, capacity=cfg.init_capacity,
                                         device=self.device)
        self.step = 0
        # stream position consumed, per partition: {partition: next
        # unconsumed offset}; stamped by ``partial_fit(offset=...)`` and
        # checkpointed with the tables (utils.checkpoint.save_online_state)
        self.consumed_offsets: dict[int, int] = {}
        # concurrent-apply mode: off by default (the serial path takes no
        # lock); when on, partial_fit runs _partial_fit_concurrent
        self._concurrent = False
        self.apply_lock = named_rlock("online.apply_lock")
        # optional streams.parallel.RowConflictGate: the concurrent path
        # claims the batch's user and item ids for the snapshot → commit
        # window, so only genuinely colliding batches serialize
        self.apply_gate = None
        # divergence guard: ``after_batch(model, U, V, u_rows, i_rows)``
        # before the offset stamp; None = one pointer test per batch
        self.watchdog = None
        obs = get_registry()
        self._obs_on = obs.enabled
        self._trace = get_tracer()
        self._events = get_events()
        self._m_batch_s = obs.histogram("online_batch_s")
        self._m_batches = obs.counter("online_batches_total")
        self._m_ratings = obs.counter("online_ratings_total")

    # -- training ----------------------------------------------------------

    def enable_concurrent_applies(self, enabled: bool = True) -> None:
        """Route ``partial_fit`` through the snapshot/commit concurrent
        path. The caller owns conflict-freedom: two applies may overlap only
        when their (user, item) row sets are disjoint (``apply_gate``, a
        ``streams.parallel.RowConflictGate``, guards it), because each
        commit writes back only its own touched rows. Disjoint-row applies
        commute, so any interleaving equals some serial order."""
        self._concurrent = bool(enabled)

    @property
    def concurrent_applies(self) -> bool:
        return self._concurrent

    def partial_fit(self, batch: Ratings,
                    iterations: int | None = None,
                    emit_updates: bool = True,
                    offset: tuple[int, int] | None = None,
                    ) -> BatchUpdates | None:
        """Apply one micro-batch; return the touched vectors.

        ``emit_updates=False`` skips the updates-only output (returns
        ``None``): ingest mode, for callers that read the tables instead.
        ``offset=(partition, end_offset)`` stamps the batch's stream
        position into ``consumed_offsets`` once the batch is applied (also
        for an all-padding batch: the position advanced)."""
        if self._concurrent:
            return self._partial_fit_concurrent(
                batch, iterations=iterations, emit_updates=emit_updates,
                offset=offset)
        cfg = self.config
        ru, ri, rv, rw = batch.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]
        if len(ru) == 0:
            if offset is not None:
                self.consumed_offsets[int(offset[0])] = int(offset[1])
            return (BatchUpdates([], [], rank=cfg.num_factors)
                    if emit_updates else None)

        t0 = time.perf_counter() if self._obs_on else 0.0
        caps = self._capacities()
        u_rows = self.users.acquire_rows(ru)
        i_rows = self.items.acquire_rows(ri)
        if caps is not None and caps != self._capacities():
            self._emit_growth()
        try:
            U, V = self._train(self.users.array, self.items.array, u_rows,
                               i_rows, rv, len(ru), iterations)
            self.users.install_trained(U, u_rows)
            self.items.install_trained(V, i_rows)
        finally:
            self.users.release_rows(u_rows)
            self.items.release_rows(i_rows)
        self.step += 1
        if self._obs_on:
            self._observe_batch(t0, _batch_done(U), len(ru))
        if self.watchdog is not None:
            # before the offset stamp: a tripped batch never claims its
            # stream position
            self.watchdog.after_batch(self, U, V, u_rows, i_rows)
        if offset is not None:
            self.consumed_offsets[int(offset[0])] = int(offset[1])
        if not emit_updates:
            return None

        # one bulk gather of the touched rows per side, through a
        # pow2-padded index (repeating row 0)
        uniq_u, first_u = np.unique(ru, return_index=True)
        uniq_i, first_i = np.unique(ri, return_index=True)

        def gather(table, rows):
            n = len(rows)
            idx = np.zeros(pow2_pad(n), np.int64)
            idx[:n] = rows
            return table[torch.from_numpy(idx).to(self.device)].cpu() \
                .numpy()[:n]

        return self._emit_updates(
            lambda: ((uniq_u.astype(np.int64), gather(U, u_rows[first_u])),
                     (uniq_i.astype(np.int64), gather(V, i_rows[first_i]))))

    def _partial_fit_concurrent(self, batch: Ratings,
                                iterations: int | None = None,
                                emit_updates: bool = True,
                                offset: tuple[int, int] | None = None,
                                ) -> BatchUpdates | None:
        """The concurrent-apply twin of ``partial_fit``: correct iff no
        concurrent apply shares a row between snapshot and commit (the
        ``apply_gate`` claim). A snapshot's other rows may go stale
        underneath (another consumer's commit, a growth); neither matters:
        our rows are claimed, and growth keeps row indices. The watchdog
        scans before the commit, so a tripped batch never reaches the live
        tables."""
        cfg = self.config
        ru, ri, rv, rw = batch.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]
        if len(ru) == 0:
            if offset is not None:
                with self.apply_lock:
                    self.consumed_offsets[int(offset[0])] = int(offset[1])
            return (BatchUpdates([], [], rank=cfg.num_factors)
                    if emit_updates else None)
        token = None
        if self.apply_gate is not None:
            token = self.apply_gate.acquire(np.unique(ru), np.unique(ri))
        try:
            return self._apply_concurrent(
                ru, ri, rv, iterations=iterations,
                emit_updates=emit_updates, offset=offset)
        finally:
            if token is not None:
                self.apply_gate.release(token)

    def _apply_concurrent(self, ru, ri, rv, iterations=None,
                          emit_updates=True, offset=None):
        t0 = time.perf_counter() if self._obs_on else 0.0
        with self.apply_lock:
            caps = self._capacities()
            u_rows = self.users.acquire_rows(ru)
            i_rows = self.items.acquire_rows(ri)
            grew = caps is not None and caps != self._capacities()
            U0 = self.users.array  # never written in place: the snapshot
            V0 = self.items.array  # is two references, no copy
        try:
            if grew:  # journaled outside the lock
                self._emit_growth()
            U, V = self._train(U0, V0, u_rows, i_rows, rv, len(ru),
                               iterations)
            if self.watchdog is not None:
                # before the commit and the offset stamp
                self.watchdog.after_batch(self, U, V, u_rows, i_rows)
            uniq_u = np.unique(u_rows)
            uniq_i = np.unique(i_rows)

            def touched_idx(rows_uniq: np.ndarray) -> torch.Tensor:
                # pow2-padded with a repeated OWN row, never row 0: row 0
                # may be another consumer's in-flight claim, and a
                # duplicate index writing its stale snapshot value would
                # corrupt it; a repeat of our own row writes our value
                n = len(rows_uniq)
                idx = np.full(pow2_pad(n), rows_uniq[0], np.int64)
                idx[:n] = rows_uniq
                return torch.from_numpy(idx).to(self.device)

            ju = touched_idx(uniq_u)
            ji = touched_idx(uniq_i)
            with self.apply_lock:
                self.users.commit_rows(U, ju)
                self.items.commit_rows(V, ji)
                self.step += 1
                if offset is not None:
                    # stamped only with the update committed
                    self.consumed_offsets[int(offset[0])] = int(offset[1])
                # marked under the lock, right after this batch's commit
                done = _batch_done(self.items.array) if self._obs_on \
                    else None
        finally:
            self.users.release_rows(u_rows)
            self.items.release_rows(i_rows)
        if self._obs_on:
            # waited on after apply_lock: waiting under it would serialize
            # the consumers' overlap this path exists for
            self._observe_batch(t0, done, len(ru))
        if not emit_updates:
            return None

        def updates_for(ids, rows, rows_uniq, src, jidx):
            # id-aligned: rows are first-seen ordered, ids sorted, so map
            # each sorted-unique id's row to its place in the sorted-unique
            # ROW gather of the trained table (the committed values)
            vals = src[jidx].cpu().numpy()
            uniq_ids, first = np.unique(ids, return_index=True)
            pos = np.searchsorted(rows_uniq, rows[first])
            return uniq_ids.astype(np.int64), vals[pos]

        return self._emit_updates(
            lambda: (updates_for(ru, u_rows, uniq_u, U, ju),
                     updates_for(ri, i_rows, uniq_i, V, ji)))

    # -- the update and its obs hooks --------------------------------------

    def _train(self, U, V, u_rows, i_rows, rv, records: int, iterations):
        """Pad and stage the batch's entries on the device (an explicit
        host→device copy, noted on the transfer ledger), then train copies
        of ``U``/``V`` on them inside the ``online.partial_fit`` guard.
        Returns the trained copies."""
        cfg = self.config
        staged = sgd_ops.pad_minibatches(u_rows, i_rows, rv,
                                         cfg.minibatch_size)
        ur, ir, vals, w = (torch.from_numpy(a).to(self.device)
                           for a in staged)
        ledger = get_transfers()
        if ledger is not None:
            ledger.note_transfer("online.minibatch_stage", "h2d",
                                 sum(a.nbytes for a in staged))
            ledger.observe_call("online_train", U, V, ur, ir, vals, w)
        with self._trace.span("online/partial_fit",
                              key=("online_train", len(ur)),
                              records=records):
            with guard_scope("online.partial_fit"):
                return sgd_ops.online_train(
                    U, V, ur, ir, vals, w, updater=self.updater,
                    minibatch=cfg.minibatch_size,
                    iterations=(iterations if iterations is not None
                                else cfg.iterations_per_batch),
                    collision=cfg.collision_mode)

    def _capacities(self) -> tuple[int, int] | None:
        """Both tables' capacities when a journal is installed (growth
        detection), else ``None``."""
        if self._events is None:
            return None
        return self.users.capacity, self.items.capacity

    def _emit_growth(self) -> None:
        self._events.emit("online.table_growth", step=self.step,
                          users_capacity=int(self.users.capacity),
                          items_capacity=int(self.items.capacity))

    def _observe_batch(self, t0: float, done, records: int) -> None:
        """Wait for the batch's last write (``done``, from
        ``_batch_done``), then observe its wall since ``t0`` and count
        it."""
        _wait(done)
        self._m_batch_s.observe(time.perf_counter() - t0)
        self._m_batches.inc()
        self._m_ratings.inc(records)

    def _emit_updates(self, pull) -> BatchUpdates:
        """The updates-only output from ``pull() -> (user_arrays,
        item_arrays)``, the device→host pull noted on the transfer ledger
        (the emitted vectors' bytes, its wall)."""
        ledger = get_transfers()
        t0 = time.perf_counter() if ledger is not None else 0.0
        user_arrays, item_arrays = pull()
        if ledger is not None:
            ledger.note_transfer("online.emit_updates", "d2h",
                                 user_arrays[1].nbytes
                                 + item_arrays[1].nbytes,
                                 time.perf_counter() - t0)
        return BatchUpdates(user_arrays=user_arrays, item_arrays=item_arrays,
                            rank=self.config.num_factors)

    def run(self, batches: Iterable[Ratings],
            limiter: ThroughputLimiter | None = None,
            ) -> Iterator[BatchUpdates]:
        """Drive a paced stream of micro-batches through the model."""
        for batch in batches:
            if limiter is not None:
                limiter.emit_batch_or_wait(int(batch.n))
            yield self.partial_fit(batch)

    # -- scoring -----------------------------------------------------------

    def _rows(self, *arrays):
        return [torch.as_tensor(np.asarray(a), device=self.device)
                for a in arrays]

    def predict(self, user_ids, item_ids, return_mask: bool = False):
        """Score pairs against the live model; unseen ids score 0.
        ``return_mask=True`` → ``(scores, seen)``."""
        u_rows, u_mask = self.users.rows_for(np.asarray(user_ids))
        i_rows, i_mask = self.items.rows_for(np.asarray(item_ids))
        scores = sgd_ops.predict_rows(
            self.users.full_table(), self.items.full_table(),
            *self._rows(u_rows, i_rows)).cpu().numpy()
        return masked_scores(scores, u_mask, i_mask, return_mask)

    def rmse(self, data: Ratings) -> float:
        ru, ri, rv, rw = data.to_numpy()
        u_rows, u_mask = self.users.rows_for(ru)
        i_rows, i_mask = self.items.rows_for(ri)
        mask = (u_mask * i_mask * rw).astype(np.float32)
        n = mask.sum()
        if n == 0:
            return float("nan")
        sse = sgd_ops.sse_rows(self.users.full_table(),
                               self.items.full_table(),
                               *self._rows(u_rows, i_rows, rv, mask))
        return float(np.sqrt(float(sse) / n))

    # -- export ------------------------------------------------------------

    def to_model(self) -> MFModel:
        """The live state as a standard ``MFModel`` (copies of the rows seen
        so far, on the model's device): serving, ranking quality and
        ``save_mf_model`` for stream-trained factors. Rows ingested later do
        not appear."""

        def side(table):
            n = table.num_rows
            idx = flat_index(table.id_array(),
                             sorted_pair=table.sorted_index())
            if n == 0:  # flat_index's 1-row empty-vocab shape
                return torch.zeros((1, table.rank), dtype=torch.float32,
                                   device=self.device), idx
            return table.full_table()[:n].clone(), idx

        U, users = side(self.users)
        V, items = side(self.items)
        return MFModel(U=U, V=V, users=users, items=items)

    def user_factors(self) -> dict[int, np.ndarray]:
        return self.users.as_dict()

    def item_factors(self) -> dict[int, np.ndarray]:
        return self.items.as_dict()
