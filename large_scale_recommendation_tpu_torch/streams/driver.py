"""StreamingDriver: the crash-recovering online → serve ingest loop
(counterpart of ``large_scale_recommendation_tpu.streams.driver``).

An ``EventLog`` partition is tailed (``LogTailSource``) through a bounded
backpressure queue (``QueuedSource``) into ``OnlineMF`` / ``AdaptiveMF``
micro-batch updates, with the consumed WAL offset checkpointed atomically
alongside the factor tables (``utils.checkpoint.save_online_state``); each
adaptive retrain swap reaches live ``ServingEngine``s through their
versioned catalogs, observed here via ``engine.on_refresh``.

Recovery contract:

- **at-least-once, zero loss**: a batch's offset stamp is recorded only
  once its update is applied (``partial_fit(offset=...)``), and a
  checkpoint persists factors and offset as one snapshot. ``resume()``
  re-tails the log from the checkpointed offset: every rating after it is
  replayed, none is skipped.
- **bounded duplication**: what is replayed twice is at most the batches
  applied since the last checkpoint, ≤ ``checkpoint_every``. While an
  ``AdaptiveMF(background=True)`` retrain is in flight, arriving batches
  are buffered with a frozen offset stamp: the driver holds checkpoints in
  that window (they could only repeat the pre-retrain offset) and writes
  one as soon as the swap replays the buffer.
- **retrain history rebuild**: an ``AdaptiveMF``'s history lives in host
  memory only; ``resume()`` rebuilds it from the retained log below the
  restored offset.

WAL lookahead for a tiered user store: when the model's user table has a
``prefetch`` seam (``store.TieredFactorStore``), the feeder announces each
batch's user ids (``on_enqueue``) to a ``store.StorePrefetcher``, which
stages them into the device slot pool while earlier batches train; its
counters land in the last run's queue stats (``_last_stats["prefetch"]``).

Observability: the JAX driver's registry instruments bind at
construction (``streams_batches_total``, ``streams_records_total``,
``streams_checkpoint_s``, ``streams_queue_depth`` per partition; the
shared null instrument when obs is off). ``telemetry()`` publishes the lag
gauge (``streams_lag_records``) and the numeric queue counters
(``streams_queue_*``); ``start_telemetry_export`` runs it on a
``PeriodicTask`` so a ``/metrics`` scrape reads fresh lag.
``end_offset`` stats the disk, so the lag is read on the telemetry
cadence only, never per batch. With the tracer on, each apply is a
``stream/ingest_batch`` span under the batch's activated ``TraceContext``
(``StreamBatch.ctx``), so the update's spans join the record's trace;
each checkpoint journals a ``stream.checkpoint`` event. The stream planes
bind at construction: the lineage journal receives each applied batch's
ingest watermark (``note_ingest``) and each swap's provenance
(``_note_swap``: the watermark only this driver knows), and the
critical-path analyzer the apply-start / applied / swap marks (the applied
mark shares the ingest mark's clock read, the swap mark the lineage
record's ``wall_time``, so ``swap_lag`` reconciles exactly with the
freshness histogram). The duck-typed ``inspector``
(``inspect_batch(batch)``, e.g. ``obs.dataquality.DataQualityInspector``:
it reads the batch's host arrays before anything is staged) and
``evaluator`` (``split_batch(ratings)``) hooks see each batch first.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np

from large_scale_recommendation_tpu_torch.obs.disttrace import get_disttrace
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.lineage import get_lineage
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer
from large_scale_recommendation_tpu_torch.store.prefetch import (
    StorePrefetcher,
)
from large_scale_recommendation_tpu_torch.streams.log import EventLog
from large_scale_recommendation_tpu_torch.streams.sources import (
    LogTailSource,
    QueuedSource,
    StreamBatch,
)
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_online_state,
    save_online_state,
)
from large_scale_recommendation_tpu_torch.utils.metrics import publish_fields


@dataclasses.dataclass(frozen=True)
class StreamingDriverConfig:
    """Ingest-loop knobs.

    ``checkpoint_every`` is the duplication bound: a crash replays at most
    that many micro-batches. ``None`` hands checkpointing to an external
    coordinator (the ``ParallelIngestRunner`` barrier owns the atomic
    cross-partition commit). ``truncate_log`` opts into retention: after
    each checkpoint the log retires segments wholly below the checkpointed
    offset, never beyond it.
    """

    batch_records: int = 4096
    checkpoint_every: int | None = 1
    checkpoint_keep: int = 3
    queue_capacity: int = 16
    queue_policy: str = "block"
    poll_interval_s: float = 0.01
    truncate_log: bool = False
    emit_updates: bool = False  # pure-ingest by default (poll the model)


class StreamingDriver:
    """Wire one ``EventLog`` partition into an online model and its serving
    engines. ``model`` is an ``OnlineMF`` or an ``AdaptiveMF`` (whose
    retrain swaps refresh the engines made by ``serving_engine``); the
    model's device is where the batches train."""

    def __init__(self, model: Any, log: EventLog, checkpoint_dir: str,
                 partition: int = 0,
                 config: StreamingDriverConfig | None = None,
                 on_batch: Callable[[StreamBatch], None] | None = None,
                 inspector: Any = None, evaluator: Any = None):
        from large_scale_recommendation_tpu_torch.models.adaptive import (
            AdaptiveMF,
        )

        self.model = model
        self.log = log
        self.partition = partition
        self.config = config or StreamingDriverConfig()
        self.manager = CheckpointManager(checkpoint_dir,
                                         keep=self.config.checkpoint_keep)
        self.on_batch = on_batch
        # the inspector sees each batch before training; the evaluator
        # takes a holdout out of it (weights zeroed) before the model does
        self.inspector = inspector
        self.evaluator = evaluator
        # the stream planes (None unless installed): per-batch ingest
        # watermarks and swap provenance, the critical-path marks
        self._lineage = get_lineage()
        self._disttrace = get_disttrace()
        self._adaptive = isinstance(model, AdaptiveMF)
        self._online = model.online if self._adaptive else model
        # ids touched since the last serving refresh (what lets
        # refresh_serving ship deltas), under _dirty_lock: batches apply
        # on the consumer thread while a refresh may land from another,
        # and the take-and-replace must not erase ids marked in between
        self._dirty_users: set[int] = set()
        self._dirty_items: set[int] = set()
        self._dirty_lock = threading.Lock()
        self._stop = threading.Event()
        self._source: QueuedSource | None = None
        self._prefetcher: StorePrefetcher | None = None
        self._last_stats: dict = {}
        self.batches_processed = 0
        self.records_processed = 0
        self.checkpoints_written = 0
        self._since_checkpoint = 0
        # catalog versions observed via engine.on_refresh
        self.catalog_versions: list[int] = []
        self._engines: list = []
        # registry instruments bind at construction (null singletons when
        # obs is disabled)
        obs = get_registry()
        self._obs = obs
        self._obs_on = obs.enabled
        self._trace = get_tracer()
        self._events = get_events()
        part = str(partition)
        self._m_batches = obs.counter("streams_batches_total",
                                      partition=part)
        self._m_records = obs.counter("streams_records_total",
                                      partition=part)
        self._m_ckpt = obs.histogram("streams_checkpoint_s",
                                     partition=part)
        self._m_lag = obs.gauge("streams_lag_records", partition=part)
        self._m_depth = obs.gauge("streams_queue_depth", partition=part)
        # the timed telemetry cadence: None until started
        self._telemetry_task = None

    # -- recovery ------------------------------------------------------------

    def resume(self) -> bool:
        """Restore the latest (factors, step, WAL offset) snapshot, if any;
        returns whether one was loaded. The next ``run`` tails the log
        from the restored offset. For an ``AdaptiveMF`` the retrain history
        is rebuilt from the retained log below that offset."""
        if self.manager.latest_step() is None:
            return False
        restore_online_state(self.manager, self._online)
        if self._adaptive:
            self._rebuild_history()
        return True

    def _rebuild_history(self) -> None:
        consumed = self._online.consumed_offsets.get(self.partition)
        if consumed is None:
            return
        # reset first: a warm model (or a second resume) never doubles rows
        self.model.clear_history()
        start = self.log.start_offset(self.partition)
        limit = self.model.config.history_limit
        if limit is not None:
            # only the newest history_limit records would survive anyway
            start = max(start, consumed - limit)
        offset = start
        while offset < consumed:
            batch, nxt = self.log.read(
                self.partition, offset,
                min(self.config.batch_records, consumed - offset))
            if nxt == offset:
                break
            self.model.preload_history(batch)
            offset = nxt

    @property
    def consumed_offset(self) -> int:
        """Next unconsumed log offset of this driver's partition: restored
        by ``resume``, advanced by each applied batch, the log's retention
        floor for a fresh model."""
        offsets = self._online.consumed_offsets
        if self.partition in offsets:
            return offsets[self.partition]
        return self.log.start_offset(self.partition)

    def checkpoint(self) -> str:
        """Write one atomic (factors, step, WAL offset) snapshot now."""
        t0 = time.perf_counter() if self._obs_on else 0.0
        path = save_online_state(self.manager, self._online,
                                 self._online.step)
        if self._obs_on:
            self._m_ckpt.observe(time.perf_counter() - t0)
        self.checkpoints_written += 1
        self._since_checkpoint = 0
        if self._events is not None:
            self._events.emit("stream.checkpoint",
                              partition=self.partition,
                              step=int(self._online.step),
                              offset=int(self.consumed_offset),
                              path=path)
        if self.config.truncate_log:
            # retention chases the checkpointed offset, never the live one
            self.log.truncate_before(self.partition, self.consumed_offset)
        return path

    # -- ingest loop ---------------------------------------------------------

    def run(self, max_batches: int | None = None,
            follow: bool = False) -> int:
        """Tail the log from ``consumed_offset`` and apply micro-batches
        until caught up (``follow=False``), ``max_batches`` applied, or
        ``stop()``; returns the batches applied by this call. Every
        ``checkpoint_every`` batches a snapshot is written, and one more on
        a clean exit with progress since the last; a crash writes none."""
        cfg = self.config
        if self._stop.is_set():
            # a stop delivered before the loop started wins, and is consumed
            self._stop.clear()
            return 0
        tail = LogTailSource(
            self.log, self.partition, start_offset=self.consumed_offset,
            batch_records=cfg.batch_records, follow=follow,
            poll_interval_s=cfg.poll_interval_s)
        # duck-typed on the store's prefetch seam: plain tables have none,
        # and the wiring collapses to the plain QueuedSource
        prefetcher = None
        if hasattr(self._online.users, "prefetch"):
            prefetcher = StorePrefetcher(self._online.users).start()
        self._prefetcher = prefetcher
        self._source = QueuedSource(tail, capacity=cfg.queue_capacity,
                                    policy=cfg.queue_policy,
                                    on_enqueue=(prefetcher.submit_batch
                                                if prefetcher is not None
                                                else None))
        applied = 0
        try:
            for batch in self._source:
                self._apply(batch)
                applied += 1
                if (max_batches is not None and applied >= max_batches) \
                        or self._stop.is_set():
                    self._source.stop()
                    break
        finally:
            # on any exit, a mid-apply crash included, wind the feeder down
            # and keep its counters readable; no checkpoint here (a failed
            # batch's offset may be stamped already)
            self._source.stop()
            if prefetcher is not None:
                prefetcher.stop()
            self._last_stats = self._source.stats.snapshot()
            self._last_stats["dead_letter_buffered"] = len(
                self._source.dead_letters)
            if prefetcher is not None:
                self._last_stats["prefetch"] = prefetcher.snapshot()
        # a feeder fault surfaces even after an early exit, and before the
        # final checkpoint
        self._source.finish()
        if self._since_checkpoint and self.config.checkpoint_every is not None:
            self.checkpoint()
        self._stop.clear()
        return applied

    def _apply(self, batch: StreamBatch) -> None:
        if self._trace.enabled:
            # the batch's context is activated around the apply: every span
            # opened inside (this one, the update's, a retrain the batch
            # triggers) carries the record family's trace id
            with self._trace.activate(batch.ctx), \
                    self._trace.span("stream/ingest_batch",
                                     partition=int(batch.partition),
                                     start_offset=int(batch.start_offset),
                                     end_offset=int(batch.end_offset)):
                self._apply_batch(batch)
        else:
            self._apply_batch(batch)

    def _apply_batch(self, batch: StreamBatch) -> None:
        offset = (batch.partition, batch.end_offset)
        ratings = batch.ratings
        if self._disttrace is not None:
            # apply start: the queue_wait → train_apply boundary
            self._disttrace.note_dequeue(batch.end_offset,
                                         partition=batch.partition)
        if self.inspector is not None:
            self.inspector.inspect_batch(batch)
        if self.evaluator is not None:
            ratings = self.evaluator.split_batch(ratings)
        if self._adaptive:
            self.model.process(ratings, offset=offset,
                               emit_updates=self.config.emit_updates)
        else:
            self.model.partial_fit(
                ratings, offset=offset,
                emit_updates=self.config.emit_updates)
        if self._lineage is not None or self._disttrace is not None:
            # the ingest half of the freshness join, once the model's own
            # offset stamp shows the batch applied (a batch buffered during
            # a background retrain is not yet). One clock read shared by
            # both planes.
            applied = self._online.consumed_offsets.get(batch.partition, 0)
            if applied >= batch.end_offset:
                t_applied = time.time()
                if self._lineage is not None:
                    self._lineage.note_ingest(applied,
                                              partition=batch.partition,
                                              t=t_applied)
                if self._disttrace is not None:
                    self._disttrace.note_applied(
                        applied, partition=batch.partition, t=t_applied)
        if self._engines:  # dirty-id tracking feeds delta refreshes
            ru, ri, _, rw = ratings.to_numpy()
            real = rw > 0
            du = np.unique(ru[real]).tolist()
            di = np.unique(ri[real]).tolist()
            with self._dirty_lock:
                self._dirty_users.update(du)
                self._dirty_items.update(di)
        self.batches_processed += 1
        self.records_processed += batch.n
        self._since_checkpoint += 1
        if self._obs_on:
            self._m_batches.inc()
            self._m_records.inc(batch.n)
            if self._source is not None and self._source.queue is not None:
                self._m_depth.set(self._source.stats.depth)
        if self.on_batch is not None:
            self.on_batch(batch)
        stamped = self._online.consumed_offsets.get(batch.partition, 0)
        if stamped < batch.end_offset:
            # buffered during a background retrain: the stamp is frozen
            # until the swap replays the buffer, so a checkpoint now would
            # re-persist the pre-retrain offset. Hold; the first post-swap
            # batch writes one covering everything replayed.
            return
        if (self.config.checkpoint_every is not None
                and self._since_checkpoint >= self.config.checkpoint_every):
            self.checkpoint()

    def stop(self) -> None:
        """Ask a running ``run(follow=True)`` loop to wind down (it still
        checkpoints its progress on the way out)."""
        self._stop.set()
        if self._source is not None:
            self._source.stop()

    # -- serving -------------------------------------------------------------

    def serving_engine(self, k: int = 10, **kwargs):
        """A ``ServingEngine`` over the live model whose every refresh
        (adaptive retrain swaps arrive by themselves; online models refresh
        through ``refresh_serving``) appends its catalog version to
        ``catalog_versions``."""
        if self._adaptive:
            engine = self.model.serving_engine(k=k, **kwargs)
        else:
            from large_scale_recommendation_tpu_torch.serving.engine import (
                ServingEngine,
            )

            engine = ServingEngine(self.model.to_model(), k=k, **kwargs)
        engine.on_refresh = self.catalog_versions.append
        self.catalog_versions.append(engine.version)  # the bind itself
        self._engines.append(engine)
        self._note_swap(engine.version, self.consumed_offset,
                        source="engine_bind")
        return engine

    def _note_swap(self, version: int, watermark: int,
                   source: str) -> None:
        """One swap's causal stamps, each plane behind its own gate: the
        lineage record (enriched with this partition's watermark), the
        critical-path swap mark (at the lineage record's own ``wall_time``)
        and a ``lineage/swap_watermark`` trace instant (the version ↔
        watermark join the assembled record trace pivots on)."""
        if (self._lineage is None and self._disttrace is None
                and not self._trace.enabled):
            return
        t_swap = None
        if self._lineage is not None:
            rec = self._lineage.record_swap(
                version, wal_offset_watermark=watermark,
                partition=self.partition, train_step=int(self._online.step),
                source=source)
            t_swap = rec["wall_time"]
        if self._disttrace is not None:
            self._disttrace.note_swap(version, partition=self.partition,
                                      watermark=watermark, t=t_swap)
        if self._trace.enabled:
            self._trace.instant("lineage/swap_watermark",
                                version=int(version),
                                partition=int(self.partition),
                                watermark=int(watermark), source=source)

    def refresh_serving(self, delta: bool | None = None) -> None:
        """Push the live model's state into every attached engine.

        ``delta=None`` ships a delta whenever it can: the ids touched since
        the last refresh map to engine rows and only those rows install
        (``ServingEngine.apply_delta``). It falls back to a full
        ``refresh`` when any engine's geometry no longer matches the live
        tables (the vocabulary grew). ``delta=False`` forces the full
        rebuild; ``delta=True`` asserts a delta was possible."""
        if not self._engines:
            with self._dirty_lock:
                self._dirty_users.clear()
                self._dirty_items.clear()
            return
        online = self._online

        def geometry_matches(engine) -> bool:
            m = engine.model
            return (int(m.U.shape[0]) == online.users.num_rows
                    and int(m.V.shape[0]) == online.items.num_rows)

        can_delta = all(geometry_matches(e) for e in self._engines)
        if delta is True and not can_delta:
            raise ValueError(
                "delta refresh requested but an engine's geometry no "
                "longer matches the live tables (vocab grew) — use "
                "delta=None/False")
        # take the dirty sets atomically: ids marked after this land in
        # the new sets and ship with the next refresh
        with self._dirty_lock:
            dirty_users, self._dirty_users = self._dirty_users, set()
            dirty_items, self._dirty_items = self._dirty_items, set()
        if delta is not False and can_delta:
            du = (np.fromiter(dirty_users, np.int64, len(dirty_users))
                  if dirty_users else np.zeros(0, np.int64))
            di = (np.fromiter(dirty_items, np.int64, len(dirty_items))
                  if dirty_items else np.zeros(0, np.int64))
            u_rows, _ = online.users.rows_for(du)
            i_rows, _ = online.items.rows_for(di)
            U_vals = online.users.gather_rows(u_rows)
            V_vals = online.items.gather_rows(i_rows)
            for engine in self._engines:
                engine.apply_delta(item_rows=i_rows, V_rows=V_vals,
                                   user_rows=u_rows, U_rows=U_vals)
        else:
            snapshot = self.model.to_model()
            for engine in self._engines:
                engine.refresh(snapshot)
        if (self._lineage is not None or self._disttrace is not None
                or self._trace.enabled):
            # each engine's new version covers everything applied here:
            # the consumed offset is the servable watermark
            watermark = self.consumed_offset
            for engine in self._engines:
                self._note_swap(engine.version, watermark,
                                source="stream_refresh")

    # -- telemetry -----------------------------------------------------------

    def start_telemetry_export(self, interval_s: float = 5.0):
        """Publish ``telemetry()`` into the registry every ``interval_s``
        on a daemon thread, so a ``/metrics`` scrape between hand calls
        reads fresh stream lag. Idempotent (a running exporter is returned
        as-is) and independent of ``run()``: a stopped driver's lag against
        a still-growing log is the signal a health check wants. Stop it
        with ``stop_telemetry_export()``. Returns the ``PeriodicTask``."""
        from large_scale_recommendation_tpu_torch.obs.health import (
            ensure_periodic,
        )

        self._telemetry_task = ensure_periodic(
            self._telemetry_task, self.telemetry, interval_s,
            name=f"telemetry-p{self.partition}")
        return self._telemetry_task

    def stop_telemetry_export(self) -> None:
        task, self._telemetry_task = self._telemetry_task, None
        if task is not None:
            task.stop()

    def telemetry(self) -> dict:
        """One snapshot of the ingest tier: progress, lag against the log
        head, queue/drop/dead-letter counters of the current (or last) run,
        checkpoints written and the catalog versions observed."""
        queue = dict(self._last_stats)
        if self._source is not None and self._source.queue is not None:
            queue = self._source.stats.snapshot()
            queue["dead_letter_buffered"] = len(self._source.dead_letters)
        # this partition's lag only
        end = self.log.end_offset(self.partition)
        if self._obs_on:
            # refreshed here (the telemetry cadence), not per batch:
            # end_offset stats the disk
            self._m_lag.set(max(0, end - self.consumed_offset))
            # the numeric counters only (the JAX driver's gauge would take
            # the prefetcher's nested snapshot too, and fail on it)
            publish_fields({k: v for k, v in queue.items()
                            if isinstance(v, (int, float))},
                           registry=self._obs, prefix="streams_queue",
                           partition=str(self.partition))
        return {
            "partition": self.partition,
            "batches_processed": self.batches_processed,
            "records_processed": self.records_processed,
            "consumed_offset": self.consumed_offset,
            "log_end_offset": end,
            "lag_records": max(0, end - self.consumed_offset),
            "checkpoints_written": self.checkpoints_written,
            "catalog_versions": list(self.catalog_versions),
            "dirty_users": len(self._dirty_users),
            "dirty_items": len(self._dirty_items),
            "queue": queue,
        }
