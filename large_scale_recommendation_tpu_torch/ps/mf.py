"""PS-based offline matrix factorization (counterpart of
``large_scale_recommendation_tpu.ps.mf``).

Users are partitioned to workers by ``abs(user) % worker_parallelism``;
item factors live on the parameter server, sharded by
``abs(item) % ps_parallelism``. Workers buffer their rating shard; when
input ends they train ``iterations`` epochs: pull item chunks (a bounded
in-flight window of ``pull_limit``), update their local user vectors and
push item deltas, which the shards merge additively.

Each worker's user table is a ``GrowableFactorTable`` on the worker's
device (the card unless ``device="cpu"``). An answer's chunk goes to the
device, ``ops.sgd.online_train`` updates the user table and the chunk, and
the item delta ``(V_new − V_old) / holders`` comes back as host numpy for
the push: a blocking device → host copy per answer. Worker threads enqueue
on the default CUDA stream and each owns its table, so one worker's growth
(a new tensor) never races another's read. The epoch reshuffle is seeded
numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

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
from large_scale_recommendation_tpu_torch.data.tables import (
    GrowableFactorTable,
)
from large_scale_recommendation_tpu_torch.models.mf import masked_scores
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.ps.core import PullAnswer
from large_scale_recommendation_tpu_torch.ps.server import (
    ShardedParameterStore,
    SimplePSLogic,
)
from large_scale_recommendation_tpu_torch.ps.transform import ps_transform
from large_scale_recommendation_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PSOfflineMFConfig:
    """The ``offline(...)`` parameters. ``lr_schedule`` decays over epochs:
    async pushes from stale pulls oscillate under a constant step."""

    num_factors: int = 10
    iterations: int = 10
    learning_rate: float = 0.01
    lr_schedule: str = "inverse_sqrt"
    worker_parallelism: int = 4
    ps_parallelism: int = 4
    pull_limit: int | None = 4  # in-flight item-chunk window per worker
    chunk_size: int = 512  # items per pull
    minibatch_size: int = 256
    seed: int = 0
    init_scale: float = 0.1


class _MFWorkerLogic:
    """Buffer ratings per item; per epoch pull each item chunk, update the
    local users on the device, push the item deltas."""

    def __init__(self, cfg: PSOfflineMFConfig, worker_id: int,
                 item_holders: dict[int, int] | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # item id -> number of workers holding >= 1 rating of it: the
        # per-item push scale (None: every worker holds every item)
        self._holders = item_holders
        init = PseudoRandomFactorInitializer(cfg.num_factors,
                                             scale=cfg.init_scale)
        self.users = GrowableFactorTable(init, device=self.device)
        self._by_item: dict[int, list[tuple[int, float]]] = {}
        self._epoch = 0
        self._chunks: list[np.ndarray] = []
        self._answered_in_epoch = 0
        self._rng = np.random.default_rng(cfg.seed + 31 * worker_id)
        self.updater = SGDUpdater(learning_rate=cfg.learning_rate,
                                  schedule=schedule_from_name(cfg.lr_schedule))

    # -- WorkerLogic ---------------------------------------------------------

    def on_recv(self, data, ps) -> None:
        user, item, value = data
        self._by_item.setdefault(int(item), []).append(
            (int(user), float(value)))

    def on_input_end(self, ps) -> None:
        """All input seen: build the chunks and start epoch 0."""
        if not self._by_item:
            return
        items = np.asarray(sorted(self._by_item), dtype=np.int64)
        n_chunks = max(1, -(-len(items) // self.cfg.chunk_size))
        self._chunks = np.array_split(items, n_chunks)
        # per chunk, once (chunks are disjoint, the first id keys one): the
        # push scale and the flat (user, item position, value) arrays
        self._scale_by_chunk: dict[int, np.ndarray] = {}
        self._data_by_chunk: dict[int, tuple] = {}
        for chunk in self._chunks:
            if self._holders is not None:
                s = np.asarray([self._holders[int(i)] for i in chunk],
                               dtype=np.float32)[:, None]
            else:
                s = np.float32(self.cfg.worker_parallelism)
            self._scale_by_chunk[int(chunk[0])] = s
            counts = [len(self._by_item[int(i)]) for i in chunk]
            us = np.empty(sum(counts), dtype=np.int64)
            vals = np.empty(len(us), dtype=np.float32)
            ips = np.repeat(np.arange(len(chunk), dtype=np.int64), counts)
            a = 0
            for i in chunk:
                for (user, value) in self._by_item[int(i)]:
                    us[a] = user
                    vals[a] = value
                    a += 1
            self._data_by_chunk[int(chunk[0])] = (us, ips, vals)
        self._issue_epoch(ps)

    def _issue_epoch(self, ps) -> None:
        order = self._rng.permutation(len(self._chunks))
        self._answered_in_epoch = 0
        for c in order:
            ps.pull(self._chunks[c])

    def on_pull_answer(self, answer: PullAnswer, ps) -> None:
        """Update the user vectors and the pulled chunk on the device, push
        the chunk's delta back as host numpy."""
        cfg = self.cfg
        items, V_chunk = answer.ids, answer.values
        us, ips, vals = self._data_by_chunk[int(items[0])]
        # shuffle: the item-grouped order maximizes minibatch collisions
        perm = self._rng.permutation(len(us))
        us = us[perm]
        ips = ips[perm]
        vals = vals[perm]
        u_rows = self.users.ensure(us)

        mb = cfg.minibatch_size
        staged = sgd_ops.pad_minibatches(u_rows, ips, vals, mb)
        ur, ir, rv, w = (torch.from_numpy(a).to(self.device) for a in staged)
        V_old = torch.from_numpy(
            np.asarray(V_chunk, dtype=np.float32)).to(self.device)
        U_new, V_new = sgd_ops.online_train(
            self.users.array, V_old, ur, ir, rv, w,
            updater=self.updater, minibatch=mb, iterations=1,
            t0=self._epoch,  # the schedule advances across epochs
        )
        self.users.array = U_new
        # each holder of an item pushes a full update from the same stale
        # pull: averaging over the holders keeps the combined step at the
        # intended size (the user side is worker-exclusive)
        scale = self._scale_by_chunk[int(items[0])]
        deltas = (V_new - V_old).cpu().numpy() / scale
        ps.push(items, deltas)

        self._answered_in_epoch += 1
        if self._answered_in_epoch == len(self._chunks):
            self._epoch += 1
            if self._epoch < cfg.iterations:
                self._issue_epoch(ps)

    def close(self, ps) -> None:
        """Emit the final user vectors."""
        for fv in self.users.factor_vectors():
            ps.output((fv.id, fv.factors))


class PSOfflineMF:
    """PS-mode offline MF; ``device=None`` trains the workers' user tables
    on the card."""

    def __init__(self, config: PSOfflineMFConfig | None = None, device=None):
        self.config = config or PSOfflineMFConfig()
        self.device = resolve_device(device)
        self.user_factors: dict[int, np.ndarray] = {}
        self.item_factors: dict[int, np.ndarray] = {}

    def offline(self, ratings: Ratings) -> tuple[dict, dict]:
        cfg = self.config
        ru, ri, rv, rw = ratings.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]
        if len(ru) == 0:
            raise ValueError("cannot fit on an empty ratings set")

        shard = np.abs(ru) % cfg.worker_parallelism
        inputs = [
            list(zip(ru[shard == w].tolist(), ri[shard == w].tolist(),
                     rv[shard == w].tolist()))
            for w in range(cfg.worker_parallelism)
        ]
        # how many workers hold >= 1 rating of each item
        pairs = np.unique(np.stack([shard, ri]), axis=1)
        hold_items, hold_counts = np.unique(pairs[1], return_counts=True)
        item_holders = dict(zip(hold_items.tolist(), hold_counts.tolist()))
        workers = [_MFWorkerLogic(cfg, w, item_holders=item_holders,
                                  device=self.device)
                   for w in range(cfg.worker_parallelism)]
        init = PseudoRandomFactorInitializer(cfg.num_factors,
                                             scale=cfg.init_scale)
        store = ShardedParameterStore(
            lambda p: SimplePSLogic(init, emit_updates=False),
            cfg.ps_parallelism,
        )
        worker_outs, _ = ps_transform(
            inputs, workers, store, pull_limit=cfg.pull_limit,
        )

        self.user_factors = {i: v for out in worker_outs for (i, v) in out}
        self.item_factors = store.snapshot()
        return self.user_factors, self.item_factors

    # -- scoring -------------------------------------------------------------

    @staticmethod
    def _lookup(table: dict[int, np.ndarray], ids: np.ndarray,
                rank: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized dict → (vectors, found mask) via sorted binary search."""
        keys = np.fromiter(table.keys(), dtype=np.int64, count=len(table))
        order = np.argsort(keys)
        keys = keys[order]
        mat = np.stack([table[int(k)] for k in keys]) if len(keys) else \
            np.zeros((0, rank), np.float32)
        pos = np.clip(np.searchsorted(keys, ids), 0, max(len(keys) - 1, 0))
        found = (keys[pos] == ids) if len(keys) else np.zeros(len(ids), bool)
        vecs = mat[pos] if len(keys) else np.zeros((len(ids), rank),
                                                     np.float32)
        return vecs, found

    def predict(self, user_ids, item_ids, return_mask: bool = False):
        """Pairs with an unseen user or item score 0. ``return_mask=True``
        → ``(scores, seen)``."""
        user_ids = np.asarray(user_ids, dtype=np.int64)
        item_ids = np.asarray(item_ids, dtype=np.int64)
        rank = self.config.num_factors
        uu, u_ok = self._lookup(self.user_factors, user_ids, rank)
        vv, i_ok = self._lookup(self.item_factors, item_ids, rank)
        return masked_scores(np.einsum("nk,nk->n", uu, vv), u_ok, i_ok,
                             return_mask)

    def rmse(self, data: Ratings) -> float:
        ru, ri, rv, rw = data.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]
        rank = self.config.num_factors
        uu, u_ok = self._lookup(self.user_factors, np.asarray(ru, np.int64),
                                rank)
        vv, i_ok = self._lookup(self.item_factors, np.asarray(ri, np.int64),
                                rank)
        known = u_ok & i_ok
        if not known.any():
            return float("nan")
        res = rv[known] - np.einsum("nk,nk->n", uu[known], vv[known])
        return float(np.sqrt(np.mean(res * res)))
