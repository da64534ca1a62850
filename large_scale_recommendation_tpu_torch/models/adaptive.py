"""Adaptive MF: continuous online updates plus a periodic full retrain
(counterpart of ``large_scale_recommendation_tpu.models.adaptive``).

The online flow is ``models.online.OnlineMF``; the retrain is
``models.dsgd.DSGD`` or ``models.als.ALS`` over the accumulated history, on
the model's device (on a card, ``DSGD.fit`` runs the CUDA step pair). Two
routes keep the history and run the retrain:

- the host route (``AdaptiveMFConfig``, the JAX package's): the history is a
  host list of batches, concatenated at each retrain and blocked on the
  host (``DSGD.fit`` / ``ALS.fit``); the install registers the retrained
  ids in the online tables and loads their rows;
- the device route (``DeviceAdaptiveMFConfig``): the history is a ring on
  the model's device of the newest ``history_limit`` ratings, held in the
  online tables' row space (a batch's ids are registered in the tables as
  it enters the ring), so the retrain is ``DSGD.fit_device`` on dense ids
  with the config's settings, and the install copies each retrained row to
  its table row. Ids outside the window keep their online rows on both
  routes.

The state machine:

    Online  — micro-batches update the live tables directly
    Batch   — a retrain runs (optionally on a background thread); arriving
              micro-batches are buffered with their offset stamps
    swap    — the retrained factors replace the online tables' rows
              (``_install``), every engine from ``serving_engine`` is
              refreshed, then the buffered batches replay through the
              online path

A retrain that raises on the background thread is re-raised by the next
``process`` or ``flush`` (the JAX package's thread dies and the swap is
skipped in silence; the port does not swallow it). ``watchdog`` (on the
online model) also gates the swap.

Observability binds at construction, as in the JAX package: each retrain
is an ``adaptive/retrain`` span (counters ``rows``, ``sweeps``; on the
retrain thread in background mode, under the triggering batch's captured
``TraceContext``; the device route's DSGD spans ``dsgd/blocking``,
``/plan``, ``/init``, ``/id_maps`` nest inside it) timed into
``adaptive_retrain_s`` / ``adaptive_retrains_total``; the journal gets
``adaptive.retrain_start`` / ``_install`` / ``_abort``. On the device
route each ring append and each window taken from the ring is an
``adaptive/history`` span (counter ``rows``) and each install an
``adaptive/install`` span (counters ``rows_u``, ``rows_v``, ``kept``: the
registered rows outside the window); a window and an install wait for
their device work. Each swap enriches every engine's lineage record with
the retrain id, the online step and, per partition, the WAL offset the
tables absorbed, marks the critical-path swap at that record's
``wall_time`` and drops a ``lineage/swap_watermark`` instant.
``apply_lock`` is the contention plane's ``adaptive.apply_lock``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Iterable, Iterator, Literal

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.limiter import ThroughputLimiter
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.models.online import (
    BatchUpdates,
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.obs.contention import named_rlock
from large_scale_recommendation_tpu_torch.obs.disttrace import get_disttrace
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.lineage import get_lineage
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer


@dataclasses.dataclass(frozen=True)
class AdaptiveMFConfig:
    """The online knobs plus the retrain's: every ``offline_every``
    batches (``None``: only on ``trigger_batch_training``) a from-scratch
    ``offline_algorithm`` fit of ``offline_iterations`` over the history
    (the newest ``history_limit`` rows, ``None``: all). Field for field
    the JAX package's config (the host route)."""

    num_factors: int = 10
    learning_rate: float = 0.01
    minibatch_size: int = 256
    offline_every: int | None = 10
    offline_algorithm: Literal["dsgd", "als"] = "dsgd"
    offline_iterations: int = 10
    lambda_: float = 0.1
    background: bool = False  # retrain on a thread
    history_limit: int | None = None
    checkpoint_every: int | None = None  # snapshot online state each N batches
    checkpoint_dir: str | None = None


@dataclasses.dataclass(frozen=True)
class DeviceAdaptiveMFConfig(AdaptiveMFConfig):
    """The device route (module docstring): a DSGD retrain with exactly
    ``retrain``'s settings (rank, λ, sweeps, schedule, minibatch, blocks,
    init, dtype; ``offline_iterations`` and ``lambda_`` are unused) over a
    ring of exactly ``history_limit`` ratings, which must be set."""

    retrain: DSGDConfig = DSGDConfig()


class AdaptiveMF:
    """Online MF with periodic full retrain from history. ``device=None``
    runs on the card (online tables and retrains alike)."""

    def __init__(self, config: AdaptiveMFConfig | None = None, device=None):
        self.config = cfg = config or AdaptiveMFConfig()
        self.online = OnlineMF(OnlineMFConfig(
            num_factors=cfg.num_factors,
            learning_rate=cfg.learning_rate,
            minibatch_size=cfg.minibatch_size,
        ), device=device)
        self.device = self.online.device
        self._history: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._history_rows = 0
        # the device route's history: int32 columns (user row, item row,
        # rating bits) of the newest ``history_limit`` ratings, written at
        # ``_ring_head``
        self._ring: torch.Tensor | None = None
        self._ring_head = 0
        if isinstance(cfg, DeviceAdaptiveMFConfig):
            if cfg.offline_algorithm != "dsgd" or cfg.history_limit is None:
                raise ValueError(
                    "the device route (DeviceAdaptiveMFConfig) retrains "
                    "with DSGD over a ring of history_limit ratings: set "
                    "offline_algorithm='dsgd' and history_limit")
            self._ring = torch.empty((3, int(cfg.history_limit)),
                                     dtype=torch.int32, device=self.device)
        self._batches_since_retrain = 0
        self.retrain_count = 0
        self._state = "Online"  # "Online" | "Batch"
        self._thread: threading.Thread | None = None
        self._retrained: MFModel | None = None
        self._retrain_error: BaseException | None = None
        # (batch, offset stamp) pairs queued while a background retrain runs
        self._buffer: list[tuple[Ratings, tuple[int, int] | None]] = []
        self._engines: "weakref.WeakSet" = weakref.WeakSet()
        # snapshot + register of an engine vs a swap landing in between
        self._engines_lock = threading.Lock()
        # observability (null singletons / None when off), all on the cold
        # retrain and swap paths
        obs = get_registry()
        self._obs_on = obs.enabled
        self._trace = get_tracer()
        self._events = get_events()
        self._lineage = get_lineage()
        self._disttrace = get_disttrace()
        self._m_retrains = obs.counter("adaptive_retrains_total")
        self._m_retrain_s = obs.histogram("adaptive_retrain_s")
        self._manager = None
        if cfg.checkpoint_dir is not None:
            from large_scale_recommendation_tpu_torch.utils.checkpoint import (
                CheckpointManager,
            )

            self._manager = CheckpointManager(cfg.checkpoint_dir)
        self._batches_since_ckpt = 0
        # parallel-ingest mode: process() serializes on apply_lock (history
        # order, the retrain counter and the buffer are one sequence)
        self._serialize_process = False
        # raw unless the contention plane is armed
        self.apply_lock = named_rlock("adaptive.apply_lock")

    # -- state -------------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    @property
    def watchdog(self):
        """The online model's divergence guard; it also gates each retrain
        swap (``_install``)."""
        return self.online.watchdog

    @watchdog.setter
    def watchdog(self, wd) -> None:
        self.online.watchdog = wd

    # -- ingest ------------------------------------------------------------

    def enable_concurrent_applies(self, enabled: bool = True) -> None:
        """Arm multi-consumer ingest (``ParallelIngestRunner``): each
        ``process`` call serializes on ``apply_lock``. The parallelism N
        consumers buy here is the pipeline around the apply (WAL tails,
        quarantine, batch prep), not the apply itself."""
        self._serialize_process = bool(enabled)

    @property
    def concurrent_applies(self) -> bool:
        return self._serialize_process

    def process(self, batch: Ratings,
                offset: tuple[int, int] | None = None,
                emit_updates: bool = True) -> BatchUpdates | None:
        """One micro-batch: history ∪= batch, online update, counters;
        retrain and swap when due. ``offset=(partition, end_offset)`` is
        the stream-position stamp; batches buffered during a background
        retrain keep their stamps and apply them in replay order.
        ``emit_updates=False`` is ingest mode (``OnlineMF.partial_fit``'s):
        no updates-only output, ``None`` returned."""
        if self._serialize_process:
            with self.apply_lock:
                return self._process(batch, offset, emit_updates)
        return self._process(batch, offset, emit_updates)

    def _process(self, batch: Ratings,
                 offset: tuple[int, int] | None = None,
                 emit_updates: bool = True) -> BatchUpdates | None:
        cfg = self.config
        self._append_history(batch)

        if self._state == "Batch":
            self._buffer.append((batch, offset))
            if self._thread is not None and self._thread.is_alive():
                return (BatchUpdates([], [], rank=cfg.num_factors)
                        if emit_updates else None)
            # retrain finished: swap, then replay the queue (this batch last)
            return self._finish_batch(emit_updates)

        out = self.online.partial_fit(batch, offset=offset,
                                      emit_updates=emit_updates)
        self._batches_since_retrain += 1
        self._maybe_checkpoint()
        if (cfg.offline_every is not None
                and self._batches_since_retrain >= cfg.offline_every):
            self.trigger_batch_training()
        return out

    def _maybe_checkpoint(self) -> None:
        cfg = self.config
        if self._manager is None or cfg.checkpoint_every is None:
            return
        self._batches_since_ckpt += 1
        if self._batches_since_ckpt >= cfg.checkpoint_every:
            from large_scale_recommendation_tpu_torch.utils.checkpoint import (
                save_online_state,
            )

            save_online_state(self._manager, self.online, self.online.step)
            self._batches_since_ckpt = 0

    def resume(self) -> bool:
        """Restore the latest online-state snapshot, if any; returns
        whether one was loaded."""
        if self._manager is None or self._manager.latest_step() is None:
            return False
        from large_scale_recommendation_tpu_torch.utils.checkpoint import (
            restore_online_state,
        )

        restore_online_state(self._manager, self.online)
        return True

    def trigger_batch_training(self) -> None:
        """Start a full retrain from history (no-op while one runs or with
        no history)."""
        if self._state == "Batch" or self._history_rows == 0:
            return
        self._batches_since_retrain = 0
        history = (self._history_window() if self._ring is not None
                   else self._history_ratings())
        if self._events is not None:
            self._events.emit("adaptive.retrain_start",
                              algorithm=self.config.offline_algorithm,
                              rows=_rows_of(history),
                              background=self.config.background)
        if self.config.background:
            self._state = "Batch"
            self._retrained = None
            self._retrain_error = None
            # the enclosing context crosses the thread hop: the retrain
            # span parents to the triggering batch's span
            ctx = (self._trace.capture_context()
                   if self._trace.enabled else None)
            self._thread = threading.Thread(
                target=self._retrain_into_slot, args=(history, ctx),
                daemon=True, name="adaptive-retrain")
            self._thread.start()
        else:
            model = self._retrain(history)
            self._install(model)
            self.retrain_count += 1

    def flush(self) -> BatchUpdates:
        """Block until a background retrain completes and swap it in."""
        if self._state != "Batch":
            return BatchUpdates([], [], rank=self.config.num_factors)
        if self._thread is not None:
            self._thread.join()
        return self._finish_batch()

    def run(self, batches: Iterable[Ratings],
            limiter: ThroughputLimiter | None = None,
            ) -> Iterator[BatchUpdates]:
        for batch in batches:
            if limiter is not None:
                limiter.emit_batch_or_wait(int(batch.n))
            yield self.process(batch)

    # -- retrain machinery --------------------------------------------------

    def _retrain(self, history) -> MFModel:
        """A from-scratch fit on the whole history (``_offline_solver``),
        inside an ``adaptive/retrain`` span that waits for the fitted
        tables, so the card's time is inside it. ``history`` is the host
        route's ``Ratings`` or the device route's ``_history_window``."""
        solver = self._offline_solver()
        with self._trace.span("adaptive/retrain",
                              algorithm=self.config.offline_algorithm,
                              rows=_rows_of(history),
                              sweeps=solver.config.iterations) as sp:
            t0 = time.perf_counter() if self._obs_on else 0.0
            if isinstance(history, Ratings):
                model = solver.fit(history)
            else:
                model = solver.fit_device(*history)
            sp.out = (model.U, model.V)
        if self._obs_on:
            self._m_retrain_s.observe(time.perf_counter() - t0)
            self._m_retrains.inc()
        return model

    def _offline_solver(self) -> DSGD | ALS:
        """The retrain's solver, on the model's device. The device route:
        DSGD with ``config.retrain`` as given. The host route: DSGD with
        the JAX package's retrain settings (constant lr 0.05, minibatch
        capped at 1,024; the step pair itself takes any minibatch, 32,768 in
        the benchmark's fits) or ALS.

        One departure from the JAX package: the host route's DSGD retrain
        starts its factors at the online tables' ``init_scale`` (0.1), where
        JAX keeps ``DSGDConfig``'s default of 1.0. At rank 128 that default
        starts every prediction near 32 and the constant-lr-0.05 fit
        diverges to NaN (the JAX package's own retrain does, on 60,000
        ratings: tests/test_torch_adaptive.py), and the swap would install
        NaN rows into the live tables."""
        cfg = self.config
        if self._ring is not None:
            return DSGD(cfg.retrain, device=self.device)
        if cfg.offline_algorithm == "als":
            return ALS(ALSConfig(
                num_factors=cfg.num_factors, lambda_=cfg.lambda_,
                iterations=cfg.offline_iterations,
            ), device=self.device)
        return DSGD(DSGDConfig(
            num_factors=cfg.num_factors, lambda_=cfg.lambda_,
            iterations=cfg.offline_iterations,
            learning_rate=0.05, lr_schedule="constant",
            minibatch_size=min(cfg.minibatch_size, 1024),
            init_scale=self.online.config.init_scale,
        ), device=self.device)

    def _retrain_into_slot(self, history, ctx=None) -> None:
        try:
            with self._trace.activate(ctx):
                self._retrained = self._retrain(history)
        except BaseException as exc:  # re-raised by _finish_batch
            self._retrain_error = exc

    def _finish_batch(self, emit_updates: bool = True
                      ) -> BatchUpdates | None:
        """Swap the retrained model in and replay the buffered queue. A
        retrain fault is raised here once, with the state left in Batch and
        the buffer kept: the next ``process`` / ``flush`` replays the
        buffer without a swap."""
        model, error = self._retrained, self._retrain_error
        self._thread = None
        self._retrained = None
        self._retrain_error = None
        if error is not None:
            raise error
        self._state = "Online"
        if model is not None:
            self._install(model)
            self.retrain_count += 1
        buffered, self._buffer = self._buffer, []
        users: list = []
        items: list = []
        for b, off in buffered:
            out = self.online.partial_fit(b, offset=off,
                                          emit_updates=emit_updates)
            if emit_updates:
                users.extend(out.user_updates)
                items.extend(out.item_updates)
        return (BatchUpdates(users, items, rank=self.config.num_factors)
                if emit_updates else None)

    def _install(self, model: MFModel) -> None:
        """Replace the online tables' rows with the retrained factors. Ids
        seen online but absent from the history snapshot keep their online
        vectors."""
        wd = self.online.watchdog
        if wd is not None:
            # a diverged retrain aborts here, before the tables and engines
            try:
                wd.check_swap(model.U, model.V)
            except BaseException:
                if self._events is not None:
                    self._events.emit("adaptive.retrain_abort",
                                      severity="error",
                                      reason="diverged_retrain",
                                      retrain_count=self.retrain_count)
                raise
        if self._ring is not None:
            self._install_rows(model)
        else:
            for table, T, index in ((self.online.users, model.U, model.users),
                                    (self.online.items, model.V, model.items)):
                real = index.ids >= 0
                rows = table.ensure(index.ids[real])
                picked = torch.from_numpy(np.nonzero(real)[0]).to(T.device)
                table.load_rows(rows, T[picked])
        # the swap is complete once serving sees it; the registry lock
        # covers only the membership read (refresh takes each engine's own)
        with self._engines_lock:
            engines = tuple(self._engines)
        snapshot = self.to_model() if engines else None
        for engine in engines:
            engine.refresh(snapshot)
        if engines and (self._lineage is not None
                        or self._disttrace is not None
                        or self._trace.enabled):
            self._stamp_swap(engines)
        if self._events is not None:
            self._events.emit("adaptive.retrain_install",
                              retrain_count=self.retrain_count + 1,
                              engines_refreshed=len(engines))

    def _install_rows(self, model: MFModel) -> None:
        """The device route's install: the retrain's ids are the online
        tables' rows, so each retrained row is copied to its own row, and
        the registered rows outside the window keep their online values."""
        with self._trace.span("adaptive/install") as sp:
            kept = 0
            for side, table, T, index in (
                    ("rows_u", self.online.users, model.U, model.users),
                    ("rows_v", self.online.items, model.V, model.items)):
                picked = torch.as_tensor(index.sorted_rows, device=T.device)
                table.load_rows(index.sorted_ids, T[picked])
                sp.note(**{side: len(index.sorted_ids)})
                kept += table.num_rows - len(index.sorted_ids)
            sp.note(kept=kept)
            self._settle()

    def _settle(self) -> None:
        """Wait for the work queued on the model's card (a span's own work:
        no retrain thread has work queued where it is called)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _stamp_swap(self, engines) -> None:
        """Enrich each engine's fresh lineage record (``refresh`` stamped
        the swap instant) with what only the retrain layer knows: the
        retrain id, the online step and, per partition, the WAL offset the
        tables absorbed (frozen at the pre-retrain offsets during a
        background retrain: what this build's history covers). The
        critical-path mark reuses the record's ``wall_time``."""
        offsets = dict(self.online.consumed_offsets) or {0: None}
        for engine in engines:
            for p, off in offsets.items():
                t_swap = None
                if self._lineage is not None:
                    rec = self._lineage.record_swap(
                        engine.version, retrain_id=self.retrain_count + 1,
                        train_step=int(self.online.step),
                        wal_offset_watermark=off, partition=p,
                        source="retrain_install")
                    t_swap = rec["wall_time"]
                if off is None:
                    continue
                if self._disttrace is not None:
                    self._disttrace.note_swap(engine.version, partition=p,
                                              watermark=off, t=t_swap)
                if self._trace.enabled:
                    self._trace.instant(
                        "lineage/swap_watermark",
                        version=int(engine.version), partition=int(p),
                        watermark=int(off), source="retrain_install")

    def serving_engine(self, k: int = 10, **kwargs):
        """A ``ServingEngine`` bound to the current snapshot (``to_model``)
        that every retrain swap refreshes. Per-batch online updates reach
        it at the next swap or through ``engine.refresh(to_model())``."""
        from large_scale_recommendation_tpu_torch.serving.engine import (
            ServingEngine,
        )

        with self._engines_lock:
            engine = ServingEngine(self.to_model(), k=k, **kwargs)
            self._engines.add(engine)
        return engine

    # -- history ------------------------------------------------------------

    def _append_history(self, batch: Ratings) -> None:
        ru, ri, rv, rw = batch.to_numpy()
        real = rw > 0
        if not real.any():
            return
        if self._ring is not None:
            self._append_ring(ru[real], ri[real], rv[real])
            return
        self._history.append((ru[real], ri[real], rv[real]))
        self._history_rows += int(real.sum())
        limit = self.config.history_limit
        if limit is not None:
            while self._history_rows > limit and len(self._history) > 1:
                dropped = self._history.pop(0)
                self._history_rows -= len(dropped[0])

    def _append_ring(self, ru, ri, rv) -> None:
        """The device route's append: register the ids in the online
        tables (rows keyed by id, as the online step would), then one
        upload of the (row, row, rating) columns into the ring, keeping
        its newest ``history_limit`` ratings."""
        ring = self._ring
        cap = ring.shape[1]
        with self._trace.span("adaptive/history", rows=len(ru)):
            cols = np.empty((3, len(ru)), np.int32)
            cols[0] = self.online.users.ensure(ru)
            cols[1] = self.online.items.ensure(ri)
            cols[2] = np.ascontiguousarray(rv, np.float32).view(np.int32)
            cols = cols[:, -cap:]
            n = cols.shape[1]
            new = torch.from_numpy(cols).to(self.device)
            a = self._ring_head
            m = min(n, cap - a)
            ring[:, a:a + m] = new[:, :m]
            ring[:, :n - m] = new[:, m:]
            self._ring_head = (a + n) % cap
            self._history_rows = min(self._history_rows + n, cap)

    def _history_window(self):
        """The device route's retrain input, a copy (appends go on during a
        background retrain): the ring's ratings in arrival order, as
        ``fit_device``'s ``(u, i, r, num_users, num_items)`` with the
        tables' rows as the dense ids."""
        n, head = self._history_rows, self._ring_head
        with self._trace.span("adaptive/history", rows=n):
            if n < self._ring.shape[1]:  # never wrapped: head == n
                window = self._ring[:, :n].clone()
            else:
                window = torch.cat([self._ring[:, head:],
                                    self._ring[:, :head]], dim=1)
            self._settle()
        return (window[0], window[1], window[2].view(torch.float32),
                self.online.users.num_rows, self.online.items.num_rows)

    def clear_history(self) -> None:
        """Drop the retrain history (the crash-recovery refill resets it
        before rebuilding from the log)."""
        self._history.clear()
        self._history_rows = 0
        self._ring_head = 0

    def preload_history(self, batch: Ratings) -> None:
        """Refill the retrain history without a gradient step (the
        crash-recovery path); ``history_limit`` applies. The device route
        registers the batch's ids in the online tables."""
        self._append_history(batch)

    def _history_ratings(self) -> Ratings:
        ru = np.concatenate([h[0] for h in self._history])
        ri = np.concatenate([h[1] for h in self._history])
        rv = np.concatenate([h[2] for h in self._history])
        return Ratings.from_arrays(ru, ri, rv)

    # -- scoring ------------------------------------------------------------

    def predict(self, user_ids, item_ids, return_mask: bool = False):
        return self.online.predict(user_ids, item_ids,
                                   return_mask=return_mask)

    def rmse(self, data: Ratings) -> float:
        return self.online.rmse(data)

    def to_model(self) -> MFModel:
        """The current serving state (the online tables, which absorb each
        retrain's swap) as an ``MFModel``."""
        return self.online.to_model()


def _rows_of(history) -> int:
    """Ratings in a retrain's input (either route's)."""
    if isinstance(history, Ratings):
        return int(history.n)
    return int(history[0].shape[0])
