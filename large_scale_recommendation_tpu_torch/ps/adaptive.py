"""PS-hosted combined online + periodic-batch matrix factorization
(counterpart of ``large_scale_recommendation_tpu.ps.adaptive``).

A rating stream trains online; an external trigger switches BOTH the
workers and the PS shards through a three-state machine

    Online  →  BatchInit  →  Batch  →  Online

- **Online**: each answer updates the local user vectors and pushes item
  deltas; updated user vectors stream out; ratings accumulate in the
  history; in-flight pulls are bounded by ``pull_limit_online``, overflow
  parks in the online queue. ``online_mode="chunked"`` drains up to
  ``online_chunk_size`` parked ratings per pull (one vectorized numpy
  minibatch-mean update per answer); ``"per_rating"`` is the reference's
  one-rating protocol through ``SGDUpdater.delta_np``. Both are host numpy.
- **Trigger**: the worker flips to BatchInit, sends "batch_start" to every
  shard in band, discards answers to still-in-flight online pulls, and
  starts the replay once drained.
- **Batch**: the worker replays its whole history ``iterations`` times
  (window ``pull_limit``) through ``ops.sgd.online_train`` on a dense
  replay table of the history's users on the worker's device (the card
  unless ``device="cpu"``), written back to the host map once at batch
  end. Then "batch_end" to every shard, the parked online ratings fold
  into the history (only the tail not already in it: the JAX package's
  fix of the reference's double-counted history), back to Online.
- **Server mirror**: the first "batch_start" flips a shard to BatchInit
  and clears its parameters (the batch retrains from scratch); pushes from
  workers that have not signed are ignored; all signed → Batch; all
  "batch_end" → Online. Shards always answer pulls (the reference's
  dropped pulls deadlock a FIFO channel).

The replay table and the pulled chunk are zero-padded to pow2 rows as in
the JAX package; pad rows are never referenced.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.core.updaters import (
    SGDUpdater,
    schedule_from_name,
)
from large_scale_recommendation_tpu_torch.data.tables import HostFactorTable
from large_scale_recommendation_tpu_torch.models.mf import masked_scores
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.ps.core import PullAnswer
from large_scale_recommendation_tpu_torch.ps.mf import PSOfflineMF
from large_scale_recommendation_tpu_torch.ps.server import (
    ShardedParameterStore,
)
from large_scale_recommendation_tpu_torch.ps.transform import ps_transform
from large_scale_recommendation_tpu_torch.utils.device import resolve_device
from large_scale_recommendation_tpu_torch.utils.shapes import pad_axis0_pow2


class _BatchTrigger:
    """Marker event: start a periodic batch retrain now (broadcast to
    every worker by the driver)."""

    def __repr__(self) -> str:  # pragma: no cover
        return "BATCH_TRIGGER"


BATCH_TRIGGER = _BatchTrigger()

ONLINE, BATCH_INIT, BATCH = "online", "batch_init", "batch"


@dataclasses.dataclass(frozen=True)
class PSOnlineBatchConfig:
    """The ``offlineOnlinePS(...)`` parameters, with separate batch and
    online pull windows."""

    num_factors: int = 10
    iterations: int = 5  # history replays per batch retrain
    learning_rate: float = 0.05
    lr_schedule: str = "inverse_sqrt"  # batch replay decay (online is t=1)
    worker_parallelism: int = 4
    ps_parallelism: int = 4
    pull_limit: int = 4  # batch in-flight chunk window
    pull_limit_online: int = 8  # online in-flight window (ratings or chunks)
    chunk_size: int = 256  # items per batch pull
    minibatch_size: int = 256
    seed: int = 0
    init_scale: float = 0.1
    # online path granularity: "chunked" drains up to online_chunk_size
    # parked ratings per pull (one vectorized minibatch-mean update per
    # answer); "per_rating" is the reference's one-rating-per-pull protocol
    online_mode: str = "chunked"
    online_chunk_size: int = 512  # max parked ratings drained per pull


class OnlineBatchWorkerLogic:
    """The worker state machine; the batch replay trains on ``device``."""

    def __init__(self, cfg: PSOnlineBatchConfig, worker_id: int,
                 device=None):
        if cfg.online_mode not in ("chunked", "per_rating"):
            raise ValueError(
                f"unknown online_mode {cfg.online_mode!r}; expected "
                "'chunked' or 'per_rating'")
        self.cfg = cfg
        self.worker_id = worker_id
        self.device = resolve_device(device)
        self._init = PseudoRandomFactorInitializer(cfg.num_factors,
                                                   scale=cfg.init_scale)
        # a host map, as the reference's HashMap: the online path touches
        # one vector per rating; the batch replay builds a dense device
        # table from it once per retrain
        self.users: dict[int, np.ndarray] = {}
        self.state = ONLINE
        self.history: list[tuple[int, int, float]] = []
        # ratings awaiting an online pull slot
        self.online_queue: collections.deque = collections.deque()
        # item → FIFO of (user, rating) awaiting that item's answer
        # (per_rating mode)
        self._item_fifo: dict[int, collections.deque] = {}
        # chunked mode: request_id → (users, item-positions, values) of the
        # drained group. The client assigns request ids in pull() call
        # order, so counting our own pulls gives exact, order-robust
        # answer matching (answers can complete out of order when pulls
        # span different shard sets).
        self._pull_seq = 0
        self._group_data: dict[int, tuple] = {}
        self._input_ended = False
        self._outstanding = 0
        self.updater = SGDUpdater(learning_rate=cfg.learning_rate)
        self._batch_sched = schedule_from_name(cfg.lr_schedule)
        self._rng = np.random.default_rng(cfg.seed + 31 * worker_id)
        # batch replay bookkeeping
        self._chunks: list[np.ndarray] = []
        self._chunk_data: dict[int, tuple] = {}  # first-id → (rows, ips, vals)
        self._chunk_cursor = 0
        self._epoch = 0
        self._queue_in_history = 0  # online_queue prefix already in history
        self._batch_uids: np.ndarray | None = None  # replayed users (rows)
        self._batch_U: torch.Tensor | None = None  # the replay table
        self.batches_run = 0

    # -- WorkerLogic ---------------------------------------------------------

    def on_recv(self, data: Any, ps) -> None:
        if data is BATCH_TRIGGER:
            self._on_trigger(ps)
            return
        user, item, value = data
        rating = (int(user), int(item), float(value))
        # every arrival parks in the online queue; only Online also
        # appends it to the history and tries to pull
        self.online_queue.append(rating)
        if self.state == ONLINE:
            self.history.append(rating)
            self._try_sending_pulls(ps)

    def on_input_end(self, ps) -> None:
        """Input exhausted: flush any sub-chunk remainder (the chunked
        mode's accumulation gate would otherwise strand it — the topology
        considers this worker drained once no pulls are in flight)."""
        self._input_ended = True
        if self.state == ONLINE:
            self._try_sending_pulls(ps)

    def on_pull_answer(self, answer: PullAnswer, ps) -> None:
        self._outstanding -= 1
        chunked_online = answer.request_id in self._group_data
        if self.state == ONLINE:
            if chunked_online:
                self._chunked_online_update(answer, ps)
            else:
                self._online_update(answer, ps)
            self._try_sending_pulls(ps)
        elif self.state == BATCH_INIT:
            # throw the answer away, the batch starts as soon as the
            # window drains; the discarded ratings are already in the
            # history (appended on arrival), so the retrain covers them
            if chunked_online:
                del self._group_data[answer.request_id]
            else:
                item = int(answer.ids[0])
                self._item_fifo[item].popleft()
            if self._outstanding == 0:
                self._start_batch(ps)
        else:  # BATCH
            self._batch_chunk_update(answer, ps)

    def close(self, ps) -> None:
        """Emit the final user vectors (as ``ps.mf`` does)."""
        for ident, vec in self.users.items():
            ps.output((ident, vec))

    def _user_vec(self, user: int) -> np.ndarray:
        vec = self.users.get(user)
        if vec is None:
            vec = self._init(torch.tensor([user], dtype=torch.int64))[0] \
                .numpy()
            self.users[user] = vec
        return vec

    def _init_missing(self, missing: np.ndarray) -> None:
        """Initialize absent user vectors with one batched host call (the
        JAX package pads the id count to a pow2 floor to bound its
        compiles; the rows are per id, so padding changes nothing)."""
        if not len(missing):
            return
        fresh = self._init(torch.from_numpy(
            np.asarray(missing, np.int64))).numpy()
        for j, u in enumerate(missing.tolist()):
            self.users[int(u)] = fresh[j]

    def _issue_pull(self, ps, ids: np.ndarray) -> int:
        """Every pull goes through here so ``_pull_seq`` mirrors the
        client's request-id assignment (FIFO over pull() calls)."""
        rid = self._pull_seq
        self._pull_seq += 1
        ps.pull(ids)
        return rid

    # -- Online --------------------------------------------------------------

    def _try_sending_pulls(self, ps) -> None:
        """Admit parked ratings while the online window has room. In
        chunked mode one window slot carries up to ``online_chunk_size``
        ratings as a single multi-item pull, and a pull goes out only for
        a FULL chunk, an idle pipeline, or after input end — otherwise
        arrivals keep accumulating while earlier pulls are in flight
        (per-arrival pulls would degenerate every group to ~1 rating)."""
        if self.cfg.online_mode == "chunked":
            while (self._outstanding < self.cfg.pull_limit_online
                   and self.online_queue
                   and (self._outstanding == 0 or self._input_ended
                        or len(self.online_queue)
                        >= self.cfg.online_chunk_size)):
                n = min(len(self.online_queue), self.cfg.online_chunk_size)
                group = [self.online_queue.popleft() for _ in range(n)]
                gu = np.asarray([g[0] for g in group], np.int64)
                gi = np.asarray([g[1] for g in group], np.int64)
                gv = np.asarray([g[2] for g in group], np.float32)
                items = np.unique(gi)
                ipos = np.searchsorted(items, gi)
                self._outstanding += 1
                rid = self._issue_pull(ps, items)
                self._group_data[rid] = (gu, ipos, gv)
            return
        while (self._outstanding < self.cfg.pull_limit_online
               and self.online_queue):
            user, item, value = self.online_queue.popleft()
            self._item_fifo.setdefault(item, collections.deque()).append(
                (user, value)
            )
            self._outstanding += 1
            self._issue_pull(ps, np.asarray([item], dtype=np.int64))

    def _online_update(self, answer: PullAnswer, ps) -> None:
        """Update the local user vector, push the item delta, emit the
        updated user vector: one rating per answer, through the updater's
        host scalar twin ``delta_np`` (the worker's own ``SGDUpdater``)."""
        item = int(answer.ids[0])
        item_vec = np.asarray(answer.values[0], dtype=np.float32)
        user, value = self._item_fifo[item].popleft()
        user_vec = self._user_vec(user)
        du, dv = self.updater.delta_np(value, user_vec, item_vec)
        new_user = user_vec + du
        self.users[user] = np.asarray(new_user, np.float32)
        ps.push(np.asarray([item], np.int64), dv[None, :])
        ps.output((user, new_user))

    def _chunked_online_update(self, answer: PullAnswer, ps) -> None:
        """One drained group: the same plain-SGD rule as ``_online_update``
        vectorized over the whole group — minibatch semantics (every
        rating reads the pre-group factors; row collisions within the
        group take the mean of their deltas, exactly the framework-wide
        ``collision='mean'`` convention of ``ops.sgd``). One pull, one
        push, one output batch per group instead of per rating."""
        gu, ipos, gv = self._group_data.pop(answer.request_id)
        V = np.asarray(answer.values, np.float32)

        uniq_u, u_inv = np.unique(gu, return_inverse=True)
        self._init_missing(np.asarray(
            [u for u in uniq_u.tolist() if u not in self.users], np.int64))
        Umat = np.stack([self.users[int(u)] for u in uniq_u.tolist()])

        uvec = Umat[u_inv]
        ivec = V[ipos]
        lr = np.float32(self.cfg.learning_rate)
        e = lr * (gv - np.einsum("nk,nk->n", uvec, ivec))
        # collision='mean': bound the accumulated step at the base η
        cnt_u = np.bincount(u_inv).astype(np.float32)
        cnt_i = np.bincount(ipos, minlength=len(V)).astype(np.float32)
        du = (e / cnt_u[u_inv])[:, None] * ivec
        dv = (e / cnt_i[ipos])[:, None] * uvec
        np.add.at(Umat, u_inv, du)
        dV = np.zeros_like(V)
        np.add.at(dV, ipos, dv)

        for j, u in enumerate(uniq_u.tolist()):
            vec = Umat[j]
            self.users[int(u)] = vec
            ps.output((int(u), vec))
        ps.push(answer.ids, dV)

    # -- Trigger → BatchInit -------------------------------------------------

    def _on_trigger(self, ps) -> None:
        if self.state != ONLINE:
            raise RuntimeError(
                "previous batch training has not finished yet — wait longer "
                "between periodic batch triggers"
            )
        self.state = BATCH_INIT
        # Entries currently parked in the online queue were appended to the
        # history when they arrived (Online on_recv); everything enqueued
        # from here on was not. The batch-end fold adds only the new tail
        # (the reference re-adds the prefix, double-weighting it in every
        # later retrain).
        self._queue_in_history = len(self.online_queue)
        for p in range(self.cfg.ps_parallelism):
            ps.control(p, "batch_start")
        if self._outstanding == 0:
            self._start_batch(ps)

    # -- Batch replay --------------------------------------------------------

    def _start_batch(self, ps) -> None:
        self.state = BATCH
        self._epoch = 0
        if not self.history:
            self._finish_batch(ps)
            return
        # group the history by item into near-equal chunks (as ps.mf) and
        # build each chunk's (user row, item position, value) arrays once
        hu = np.asarray([r[0] for r in self.history], dtype=np.int64)
        hi = np.asarray([r[1] for r in self.history], dtype=np.int64)
        hv = np.asarray([r[2] for r in self.history], dtype=np.float32)
        items = np.unique(hi)
        n_chunks = max(1, -(-len(items) // self.cfg.chunk_size))
        self._chunks = list(np.array_split(items, n_chunks))
        # dense device table over exactly the replayed users, built once
        # from the host map and written back once at batch end; history
        # users whose online pulls went unanswered are initialized first
        self._batch_uids = np.unique(hu)
        self._init_missing(np.asarray(
            [u for u in self._batch_uids.tolist()
             if u not in self.users], np.int64))
        # pow2 rows, as the JAX package (zero pad rows, never referenced)
        self._batch_U = torch.from_numpy(pad_axis0_pow2(np.stack(
            [self.users[int(u)] for u in self._batch_uids]))).to(
                self.device)
        order = np.argsort(hi, kind="stable")
        hu, hi, hv = hu[order], hi[order], hv[order]
        hrows = np.searchsorted(self._batch_uids, hu)
        starts = np.searchsorted(hi, items)
        ends = np.append(starts[1:], len(hi))
        self._chunk_data = {}
        for chunk in self._chunks:
            a = starts[np.searchsorted(items, chunk[0])]
            b = ends[np.searchsorted(items, chunk[-1])]
            # item position within the chunk, aligned with the pull answer
            ips = np.searchsorted(chunk, hi[a:b])
            self._chunk_data[int(chunk[0])] = (hrows[a:b], ips, hv[a:b])
        self._issue_epoch(ps)

    def _issue_epoch(self, ps) -> None:
        """One replay round under the ``pull_limit`` window, in a seeded
        shuffled chunk order."""
        self._order = self._rng.permutation(len(self._chunks))
        self._chunk_cursor = 0
        self._answered_in_epoch = 0
        self._pump_batch_pulls(ps)

    def _pump_batch_pulls(self, ps) -> None:
        while (self._chunk_cursor < len(self._chunks)
               and self._outstanding < self.cfg.pull_limit):
            chunk = self._chunks[self._order[self._chunk_cursor]]
            self._chunk_cursor += 1
            self._outstanding += 1
            self._issue_pull(ps, chunk)

    def _batch_chunk_update(self, answer: PullAnswer, ps) -> None:
        """One replayed chunk through ``online_train`` on the replay table
        (t follows the epoch, so the schedule spans the whole retrain)."""
        cfg = self.cfg
        items, V_chunk = answer.ids, answer.values
        u_rows, ips, vals = self._chunk_data[int(items[0])]
        perm = self._rng.permutation(len(u_rows))
        u_rows = u_rows[perm]
        ips = ips[perm]
        vals = vals[perm]

        mb = cfg.minibatch_size
        staged = sgd_ops.pad_minibatches(u_rows, ips, vals, mb)
        ur, ir, rv, w = (torch.from_numpy(a).to(self.device) for a in staged)

        m = len(V_chunk)
        V_old = torch.from_numpy(pad_axis0_pow2(
            np.asarray(V_chunk, np.float32))).to(self.device)
        batch_updater = SGDUpdater(learning_rate=cfg.learning_rate,
                                   schedule=self._batch_sched)
        U_new, V_new = sgd_ops.online_train(
            self._batch_U, V_old, ur, ir, rv, w,
            updater=batch_updater, minibatch=mb, iterations=1,
            t0=self._epoch,
        )
        self._batch_U = U_new
        ps.push(items, V_new[:m].cpu().numpy()
                - np.asarray(V_chunk, np.float32))

        self._answered_in_epoch += 1
        if self._answered_in_epoch == len(self._chunks):
            self._epoch += 1
            if self._epoch < cfg.iterations:
                self._issue_epoch(ps)
            elif self._outstanding == 0:
                self._finish_batch(ps)
        else:
            self._pump_batch_pulls(ps)

    def _finish_batch(self, ps) -> None:
        """Sign every shard, fold the parked online ratings into the
        history, resume Online."""
        if self._batch_uids is not None:
            # one download: the retrained rows back into the host map
            U_np = self._batch_U.cpu().numpy()
            for j, u in enumerate(self._batch_uids.tolist()):
                self.users[int(u)] = U_np[j]
            self._batch_uids = None
            self._batch_U = None
        for p in range(self.cfg.ps_parallelism):
            ps.control(p, "batch_end")
        # the parked online ratings, minus the prefix already in the
        # history (see _on_trigger)
        new_tail = list(self.online_queue)[self._queue_in_history:]
        self.history.extend(new_tail)
        self.state = ONLINE
        self.batches_run += 1
        self._try_sending_pulls(ps)


class AdaptivePSLogic:
    """The server state machine: a host-resident parameter shard whose
    behavior follows the batch lifecycle (``device`` is accepted as the
    JAX package accepts it, and ignored)."""

    def __init__(self, initializer, worker_parallelism: int, device=None):
        del device
        self._initializer = initializer
        self.table = HostFactorTable(initializer)
        self.state = ONLINE
        self.worker_parallelism = worker_parallelism
        self._started: set[int] = set()
        self._finished: set[int] = set()
        self.batches_seen = 0

    # -- ParameterServerLogic ------------------------------------------------

    def on_pull(self, ids: np.ndarray) -> np.ndarray:
        """Always answers, in BatchInit too (see the module docstring)."""
        rows = self.table.ensure(ids)
        return self.table.array[rows]

    def on_push(self, ids: np.ndarray, deltas: np.ndarray, outputs: list,
                worker_id: int = -1) -> None:
        if self.state == BATCH_INIT and worker_id not in self._started:
            # a stale online push from a worker still before its trigger
            return
        rows = self.table.ensure(ids)
        np.add.at(self.table.array, rows, np.asarray(deltas, np.float32))
        if self.state == ONLINE:
            # online pushes persist (above) and emit the updated vectors
            new = self.table.array[rows]
            outputs.extend(
                (int(i), new[j].copy()) for j, i in enumerate(ids.tolist())
            )

    def on_control(self, worker_id: int, payload: Any,
                   outputs: list) -> None:
        if payload == "batch_start":
            self._batch_started_sign(worker_id)
        elif payload == "batch_end":
            self._batch_finished_sign(worker_id)
        else:
            raise ValueError(f"unknown control payload {payload!r}")

    # -- state transitions ---------------------------------------------------

    def _batch_started_sign(self, worker_id: int) -> None:
        """``_started`` stays populated until the whole batch completes: a
        fast worker can finish its replay before a slow one signs start,
        so end signs must stay attributable to started workers."""
        if worker_id in self._started:
            raise RuntimeError(
                f"duplicate batch-start sign from worker {worker_id}"
            )
        if self.state == ONLINE:
            self.state = BATCH_INIT
            # retrain from scratch: drop every parameter
            self.table = HostFactorTable(self._initializer)
        self._started.add(worker_id)
        if len(self._started) == self.worker_parallelism:
            self.state = BATCH

    def _batch_finished_sign(self, worker_id: int) -> None:
        """Accepted in BatchInit too: a fast worker's early finish is
        skew, not an error."""
        if worker_id not in self._started:
            raise RuntimeError(
                f"batch-end sign from worker {worker_id} that never signed "
                "batch start"
            )
        if worker_id in self._finished:
            raise RuntimeError(
                f"duplicate batch-end sign from worker {worker_id}"
            )
        self._finished.add(worker_id)
        if len(self._finished) == self.worker_parallelism:
            self._finished.clear()
            self._started.clear()
            self.state = ONLINE
            self.batches_seen += 1

    def snapshot(self) -> dict[int, np.ndarray]:
        return self.table.as_dict()


class PSOnlineBatchMF:
    """Driver: stream ratings and triggers through the PS topology. The
    event stream may hold ``BATCH_TRIGGER`` sentinels, each broadcast to
    every worker; ratings route by ``abs(user) % worker_parallelism``.
    ``device=None`` runs the batch replays on the card."""

    def __init__(self, config: PSOnlineBatchConfig | None = None,
                 device=None):
        self.config = config or PSOnlineBatchConfig()
        self.device = resolve_device(device)
        self.user_factors: dict[int, np.ndarray] = {}
        self.item_factors: dict[int, np.ndarray] = {}
        self.online_user_updates: list = []
        self.online_item_updates: list = []

    def run(self, events, iteration_wait_time: float | None = None):
        """Consume a finite event stream to completion and return the final
        (user_factors, item_factors)."""
        cfg = self.config
        W = cfg.worker_parallelism
        inputs: list[list] = [[] for _ in range(W)]
        for ev in events:
            if ev is BATCH_TRIGGER:
                for w in range(W):
                    inputs[w].append(BATCH_TRIGGER)
            else:
                u = int(ev[0])
                inputs[abs(u) % W].append(ev)

        workers = [OnlineBatchWorkerLogic(cfg, w, device=self.device)
                   for w in range(W)]
        init = PseudoRandomFactorInitializer(cfg.num_factors,
                                             scale=cfg.init_scale)
        store = ShardedParameterStore(
            lambda p: AdaptivePSLogic(init, W),
            cfg.ps_parallelism,
        )
        # pull windows are enforced by the worker state machine itself
        # (pull_limit vs pull_limit_online by state), so the client-level
        # window stays open
        worker_outs, ps_outs = ps_transform(
            inputs, workers, store, pull_limit=None,
            iteration_wait_time=iteration_wait_time,
        )

        # online emissions: (user, vec) from workers, (item, vec) from PS
        self.online_user_updates = [x for out in worker_outs for x in out]
        self.online_item_updates = list(ps_outs)
        # final model: last emission per user + server snapshot
        self.user_factors = {int(i): np.asarray(v)
                             for (i, v) in self.online_user_updates}
        self.item_factors = store.snapshot()
        self.workers = workers
        self.store = store
        return self.user_factors, self.item_factors

    # -- scoring (same contract as ps.mf) ------------------------------------

    def predict(self, user_ids, item_ids, return_mask: bool = False):
        user_ids = np.asarray(user_ids, dtype=np.int64)
        item_ids = np.asarray(item_ids, dtype=np.int64)
        rank = self.config.num_factors
        uu, u_ok = PSOfflineMF._lookup(self.user_factors, user_ids, rank)
        vv, i_ok = PSOfflineMF._lookup(self.item_factors, item_ids, rank)
        return masked_scores(np.einsum("nk,nk->n", uu, vv), u_ok, i_ok,
                             return_mask)

    def rmse(self, data: Ratings) -> float:
        """RMSE over pairs whose user AND item are known (predict masks
        unknown pairs to exactly 0)."""
        ru, ri, rv, rw = data.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]
        pred = self.predict(ru, ri)
        known = pred != 0
        if not known.any():
            return float("nan")
        res = rv[known] - pred[known]
        return float(np.sqrt(np.mean(res * res)))
