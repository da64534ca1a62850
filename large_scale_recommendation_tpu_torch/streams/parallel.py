"""Parallel ingest: N per-partition consumers feeding one shared model
(counterpart of ``large_scale_recommendation_tpu.streams.parallel``).

- **one consumer per partition**: ``ParallelIngestRunner`` composes N
  ``StreamingDriver``s, each tailing its own ``EventLog`` partition through
  its own queue on its own thread, all feeding one model.
- **conflict-free concurrent applies**: SGD updates on disjoint user and
  item rows commute exactly (Gemulla's stratum argument), so row-disjoint
  micro-batches may apply concurrently in any order. Producers make
  disjointness the common case by routing records by user
  (``route_partition``); the ``RowConflictGate`` makes it safe regardless:
  a batch claims its id sets for the snapshot → commit window, and only a
  genuinely colliding batch waits. ``OnlineMF.enable_concurrent_applies``
  is the snapshot/commit apply this rests on; an ``AdaptiveMF`` serializes
  the apply itself. Every consumer thread enqueues on the default CUDA
  stream.
- **cross-partition checkpoint barrier**: one atomic snapshot commits
  ``{partition: offset}`` for all partitions with (U, V, step), captured
  under the model's ``apply_lock``. It fires when any partition has
  ``checkpoint_every`` applied batches since the last one, so a
  kill/restart replays each partition's tail with zero loss and a
  per-partition duplicate window ≤ ``checkpoint_every``. While a
  background retrain freezes the offset stamps the barrier holds, and the
  first post-swap batch whose stamps catch up writes one covering
  snapshot.
- **delta shipping with swap coalescing**: ``refresh_serving`` ships every
  consumer's dirty rows as deferred deltas
  (``ServingEngine.apply_delta(defer=True)``) and flushes once: one
  catalog version bump per engine per refresh. Concurrent refresh requests
  coalesce too.

Each member ``StreamingDriver`` publishes its partition's registry
instruments, and ``start_telemetry_export`` / ``stop_telemetry_export``
run every driver's telemetry cadence. The runner's own: the gate's
``streams_gate_grants_total`` / ``streams_gate_waits_total``, the
barrier's ``streams_barrier_checkpoints_total``,
``streams_checkpoint_s{partition="all"}``, ``streams_barriers_held_total``
and ``streams_refreshes_coalesced_total``, a ``stream.checkpoint`` event
per barrier, the named locks of the contention plane
(``streams.row_conflict_gate``, ``streams.barrier``,
``streams.ckpt_write``, ``streams.refresh``), consumer threads checked in
and out of its thread registry, and per-partition swap provenance
(each driver's ``_note_swap``) at every engine bind and refresh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np

from large_scale_recommendation_tpu_torch.obs.contention import (
    get_contention,
    named_condition,
    named_lock,
)
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.streams.driver import (
    StreamingDriver,
    StreamingDriverConfig,
)
from large_scale_recommendation_tpu_torch.streams.log import EventLog
from large_scale_recommendation_tpu_torch.streams.sources import StreamBatch
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_online_state,
    snapshot_online_state,
)


def route_partition(user_ids, num_partitions: int) -> np.ndarray:
    """Partition of each record under user-block routing: all of one
    user's ratings land in one partition, so two partitions' batches never
    share a user row (item disjointness is the gate's job)."""
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, "
                         f"got {num_partitions}")
    return np.asarray(user_ids, dtype=np.int64) % num_partitions


def append_routed(log: EventLog, users, items, ratings) -> int:
    """Append one producer batch routed across the log's partitions by
    user (``route_partition``); returns the records appended."""
    users = np.asarray(users)
    items = np.asarray(items)
    ratings = np.asarray(ratings)
    parts = route_partition(users, log.num_partitions)
    total = 0
    for p in range(log.num_partitions):
        sel = parts == p
        if not sel.any():
            continue
        start, end = log.append_arrays(p, users[sel], items[sel],
                                       ratings[sel])
        total += end - start
    return total


class RowConflictGate:
    """Admission gate for concurrent row-disjoint applies.

    ``acquire(user_ids, item_ids)`` blocks until the claimed id sets are
    disjoint from every in-flight claim, then holds them until
    ``release``. One condition variable, both sets claimed atomically: no
    partial holds, no lock order, no deadlock. Admission is not FIFO, but
    every grant is finite, so a waiter is eventually admitted. ``grants`` /
    ``waits`` count admissions and blocked attempts.
    """

    def __init__(self):
        # raw unless the contention plane is armed: a colliding batch's
        # wait then publishes as lock_wait_s{lock="streams.row_conflict_gate"}
        self._cv = named_condition("streams.row_conflict_gate")
        self._users: set[int] = set()
        self._items: set[int] = set()
        self.grants = 0
        self.waits = 0
        obs = get_registry()
        self._m_grants = obs.counter("streams_gate_grants_total")
        self._m_waits = obs.counter("streams_gate_waits_total")

    def acquire(self, user_ids, item_ids) -> tuple[set, set]:
        # tolist() then set(): both at C speed, so the GIL is held briefly
        u = set(np.asarray(user_ids).ravel().tolist())
        i = set(np.asarray(item_ids).ravel().tolist())
        with self._cv:
            waited = False
            while not (u.isdisjoint(self._users)
                       and i.isdisjoint(self._items)):
                if not waited:
                    self.waits += 1
                    self._m_waits.inc()
                    waited = True
                self._cv.wait()
            self._users |= u
            self._items |= i
            self.grants += 1
            self._m_grants.inc()
        return u, i

    def release(self, token: tuple[set, set]) -> None:
        u, i = token
        with self._cv:
            self._users -= u
            self._items -= i
            self._cv.notify_all()

    def in_flight(self) -> tuple[int, int]:
        with self._cv:
            return len(self._users), len(self._items)


class ParallelIngestRunner:
    """N per-partition consumers over one shared model.

    ``partitions`` defaults to every partition of ``log``. With more than
    one consumer the runner arms the model's concurrent-apply mode
    (``OnlineMF``: row-disjoint snapshot/commit applies behind a shared
    ``RowConflictGate``; ``AdaptiveMF``: serialized applies) and owns the
    checkpointing: every member driver runs with ``checkpoint_every=None``
    and the barrier writes the atomic all-partition snapshot.
    ``inspector`` / ``evaluator`` are shared by the consumers.
    """

    def __init__(self, model: Any, log: EventLog, checkpoint_dir: str,
                 partitions: Iterable[int] | None = None,
                 config: StreamingDriverConfig | None = None,
                 checkpoint_every: int | None = None,
                 on_batch: Callable[[StreamBatch], None] | None = None,
                 inspector: Any = None, evaluator: Any = None):
        from large_scale_recommendation_tpu_torch.models.adaptive import (
            AdaptiveMF,
        )

        self.model = model
        self.log = log
        self.config = cfg = config or StreamingDriverConfig()
        # the barrier cadence: the member config's checkpoint_every,
        # reinterpreted per partition
        self.checkpoint_every = (cfg.checkpoint_every if checkpoint_every
                                 is None else checkpoint_every)
        if self.checkpoint_every is None:
            self.checkpoint_every = 1
        self.partitions = (list(range(log.num_partitions))
                           if partitions is None else
                           [int(p) for p in partitions])
        if len(set(self.partitions)) != len(self.partitions):
            raise ValueError(f"duplicate partitions: {self.partitions}")
        self._adaptive = isinstance(model, AdaptiveMF)
        self._online = model.online if self._adaptive else model
        # the lock that excludes in-flight applies while a snapshot is
        # captured: the adaptive apply lock (held around the whole
        # serialized process()), else the online commit lock
        self._apply_lock = (model.apply_lock if self._adaptive
                            else self._online.apply_lock)
        self.on_batch = on_batch
        self.manager = CheckpointManager(checkpoint_dir,
                                         keep=cfg.checkpoint_keep)
        self.gate: RowConflictGate | None = None
        if len(self.partitions) > 1:
            if self._adaptive:
                model.enable_concurrent_applies()
            else:
                self.gate = RowConflictGate()
                model.apply_gate = self.gate
                model.enable_concurrent_applies()
        member_cfg = dataclasses.replace(cfg, checkpoint_every=None)
        self.drivers = {
            p: StreamingDriver(model, log, checkpoint_dir, partition=p,
                               config=member_cfg,
                               on_batch=self._hook_for(p),
                               inspector=inspector, evaluator=evaluator)
            for p in self.partitions
        }
        self.inspector = inspector
        self.evaluator = evaluator
        # barrier accounting (held briefly per batch; the capture itself
        # nests the model's apply_lock, the .npz write happens outside)
        self._barrier_lock = named_lock("streams.barrier")
        # serializes the snapshot writes (two in-flight writes would race
        # the manager's retention sweep)
        self._write_lock = named_lock("streams.ckpt_write")
        self._frontier: dict[int, int] = {}
        self._since_barrier: dict[int, int] = {p: 0
                                               for p in self.partitions}
        self.checkpoints_written = 0
        self.barriers_held = 0  # frozen-stamp holds (background retrain)
        # serving: each member driver carries the engines too (dirty-id
        # tracking per batch), but only the runner swaps them
        self._engines: list = []
        self.catalog_versions: list[int] = []
        self._refresh_lock = named_lock("streams.refresh")
        self._refreshing = False
        # None = nothing pending; (delta,) = a coalesced request
        self._refresh_pending: tuple | None = None
        self.refreshes_coalesced = 0
        self._threads: list[threading.Thread] = []
        self._error: BaseException | None = None
        # consumer threads check in and out of the contention plane's
        # thread registry (None unless installed): one test per thread
        # lifetime, nothing per batch
        self._contention = get_contention()
        obs = get_registry()
        self._obs_on = obs.enabled
        self._events = get_events()
        self._m_barriers = obs.counter("streams_barrier_checkpoints_total")
        self._m_ckpt = obs.histogram("streams_checkpoint_s",
                                     partition="all")
        self._m_held = obs.counter("streams_barriers_held_total")
        self._m_coalesced = obs.counter(
            "streams_refreshes_coalesced_total")

    # -- recovery ------------------------------------------------------------

    def resume(self) -> bool:
        """Restore the latest all-partition (factors, step, ``{partition:
        offset}``) snapshot; each partition's next run re-tails from its
        restored offset. An ``AdaptiveMF``'s retrain history is rebuilt
        from every partition's retained tail (one clear, N refills)."""
        if self.manager.latest_step() is None:
            return False
        restore_online_state(self.manager, self._online)
        with self._barrier_lock:
            for p in self.partitions:
                off = self._online.consumed_offsets.get(p)
                if off is not None:
                    self._frontier[p] = off
        if self._adaptive:
            self._rebuild_history()
        return True

    def _rebuild_history(self) -> None:
        self.model.clear_history()
        limit = self.model.config.history_limit
        for p in self.partitions:
            consumed = self._online.consumed_offsets.get(p)
            if consumed is None:
                continue
            start = self.log.start_offset(p)
            if limit is not None:
                start = max(start, consumed - limit)
            offset = start
            while offset < consumed:
                batch, nxt = self.log.read(
                    p, offset,
                    min(self.config.batch_records, consumed - offset))
                if nxt == offset:
                    break
                self.model.preload_history(batch)
                offset = nxt

    # -- the cross-partition checkpoint barrier ------------------------------

    def _hook_for(self, partition: int):
        def hook(batch: StreamBatch) -> None:
            # accounting first: the batch is applied, so the frontier must
            # cover it even if the user callback raises; the barrier last,
            # so a raising callback crashes the consumer uncheckpointed
            with self._barrier_lock:
                prev = self._frontier.get(partition, 0)
                self._frontier[partition] = max(prev, batch.end_offset)
                self._since_barrier[partition] += 1
                due = (self._since_barrier[partition]
                       >= self.checkpoint_every)
            if self.on_batch is not None:
                self.on_batch(batch)
            if due:
                self.maybe_checkpoint()

        return hook

    def applied_frontier(self) -> dict[int, int]:
        """Per-partition highest applied end offset seen by this run."""
        with self._barrier_lock:
            return dict(self._frontier)

    def _stamps_caught_up(self) -> bool:
        offsets = self._online.consumed_offsets
        for p, frontier in self._frontier.items():
            if offsets.get(p, 0) < frontier:
                return False  # frozen stamp: a retrain is buffering
        return True

    def maybe_checkpoint(self) -> bool:
        """Write the barrier snapshot if progress is pending and every
        partition's stamp covers its applied frontier; hold otherwise.
        Concurrent triggers collapse: the first capture resets the pending
        counts."""
        with self._barrier_lock:
            if not any(self._since_barrier.values()):
                return False
            if not self._stamps_caught_up():
                self.barriers_held += 1
                self._m_held.inc()
                return False
            arrays, meta = self._capture_locked()
        self._write_snapshot(arrays, meta)
        return True

    def checkpoint(self) -> str:
        """Write one atomic all-partition snapshot now."""
        with self._barrier_lock:
            arrays, meta = self._capture_locked()
        return self._write_snapshot(arrays, meta)

    def _capture_locked(self) -> tuple[dict, dict]:
        """Capture under ``_barrier_lock`` (the caller's) with the model's
        ``apply_lock`` nested, and reset the window counts: every applied
        batch is either in this capture or counted in the new window. Only
        references and small id copies are taken here (the tables are never
        written in place); the device → host copy and the write come after,
        outside both locks."""
        with self._apply_lock:
            arrays, meta = snapshot_online_state(self._online)
        for p in self._since_barrier:
            self._since_barrier[p] = 0
        return arrays, meta

    def _write_snapshot(self, arrays: dict, meta: dict) -> str:
        t0 = time.perf_counter() if self._obs_on else 0.0
        with self._write_lock:
            path = self.manager.save(int(meta["step"]), arrays, meta)
        if self._obs_on:
            self._m_ckpt.observe(time.perf_counter() - t0)
            self._m_barriers.inc()
        self.checkpoints_written += 1
        offsets = {int(k): int(v) for k, v in meta["offsets"].items()}
        if self._events is not None:
            self._events.emit("stream.checkpoint",
                              partitions=sorted(offsets),
                              offsets={str(k): v
                                       for k, v in offsets.items()},
                              step=int(meta["step"]), path=path,
                              barrier=True)
        if self.config.truncate_log:
            for p, off in offsets.items():
                self.log.truncate_before(p, off)
        return path

    # -- consume loops -------------------------------------------------------

    def _consumer(self, p: int, driver: StreamingDriver, applied: dict,
                  **run_kw) -> threading.Thread:
        def consume() -> None:
            ct = self._contention
            if ct is not None:
                ct.note_thread_start()
            try:
                applied[p] = driver.run(**run_kw)
            except BaseException as exc:
                if self._error is None:
                    self._error = exc
                self.stop()
            finally:
                if ct is not None:
                    ct.note_thread_end()

        return threading.Thread(target=consume, daemon=True,
                                name=f"ingest-p{p}")

    def run(self, max_batches: int | None = None,
            follow: bool = False) -> int:
        """Drain every partition on its own consumer thread until caught up
        (``follow=False``), ``max_batches`` applied per consumer, or
        ``stop()``; returns the batches applied. A consumer fault stops the
        others and is re-raised here, with no final barrier; a clean exit
        writes one covering barrier."""
        self._error = None
        # a fresh run means go: clear a stop left by an earlier fault
        for d in self.drivers.values():
            d._stop.clear()
        applied = {p: 0 for p in self.partitions}
        self._threads = [
            self._consumer(p, d, applied, max_batches=max_batches,
                           follow=follow)
            for p, d in self.drivers.items()]
        for t in self._threads:
            t.start()
        for t in self._threads:
            t.join()
        self._threads = []
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        self.maybe_checkpoint()
        return sum(applied.values())

    def start(self, follow: bool = True) -> "ParallelIngestRunner":
        """Start the N consumer threads and return; ``stop()`` and
        ``join()`` wind them down."""
        if self._threads:
            return self
        self._error = None
        for d in self.drivers.values():
            d._stop.clear()
        applied = {p: 0 for p in self.partitions}
        self._threads = [self._consumer(p, d, applied, follow=follow)
                         for p, d in self.drivers.items()]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        for d in self.drivers.values():
            d.stop()

    def join(self) -> None:
        """Wait for started consumers, surface any fault, and write the
        final barrier on a clean exit."""
        threads, self._threads = self._threads, []
        for t in threads:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        self.maybe_checkpoint()

    # -- serving -------------------------------------------------------------

    def serving_engine(self, k: int = 10, **kwargs):
        """One ``ServingEngine`` over the shared model, registered with
        every member driver (per-batch dirty ids) and swapped only by the
        runner's coalesced ``refresh_serving``. Adaptive retrain swaps
        still refresh it through the model's own registry."""
        if self._adaptive:
            with self._apply_lock:
                engine = self.model.serving_engine(k=k, **kwargs)
        else:
            from large_scale_recommendation_tpu_torch.serving.engine import (
                ServingEngine,
            )

            with self._apply_lock:
                # no half-committed batch in the first catalog
                snapshot = self.model.to_model()
            engine = ServingEngine(snapshot, k=k, **kwargs)
        engine.on_refresh = self.catalog_versions.append
        self.catalog_versions.append(engine.version)
        self._engines.append(engine)
        for d in self.drivers.values():
            d._engines.append(engine)
            d._note_swap(engine.version, d.consumed_offset,
                         source="engine_bind")
        return engine

    def refresh_serving(self, delta: bool | None = None) -> None:
        """Ship every consumer's dirty rows into every engine as one
        coalesced swap per engine (deferred deltas, one ``flush_deltas``).
        Vocabulary growth falls back to a full refresh; ``delta=True``
        asserts it did not, ``delta=False`` forces it. Requests landing
        while a refresh is in flight coalesce: the running refresh re-runs
        once to cover them (``refreshes_coalesced`` counts them)."""
        with self._refresh_lock:
            if self._refreshing:
                self._refresh_pending = (delta,)
                self.refreshes_coalesced += 1
                self._m_coalesced.inc()
                return
            self._refreshing = True
        try:
            while True:
                self._do_refresh(delta)
                with self._refresh_lock:
                    if self._refresh_pending is None:
                        self._refreshing = False
                        return
                    (delta,) = self._refresh_pending
                    self._refresh_pending = None
        except BaseException:
            with self._refresh_lock:
                self._refreshing = False
                self._refresh_pending = None
            raise

    def _take_dirty(self) -> dict[int, tuple[set, set]]:
        out = {}
        for p, d in self.drivers.items():
            with d._dirty_lock:
                du, d._dirty_users = d._dirty_users, set()
                di, d._dirty_items = d._dirty_items, set()
            if du or di:
                out[p] = (du, di)
        return out

    def _do_refresh(self, delta: bool | None) -> None:
        if not self._engines:
            self._take_dirty()
            return
        online = self._online

        def geometry_matches(engine) -> bool:
            m = engine.model
            return (int(m.U.shape[0]) == online.users.num_rows
                    and int(m.V.shape[0]) == online.items.num_rows)

        with self._apply_lock:
            can_delta = all(geometry_matches(e) for e in self._engines)
        if delta is True and not can_delta:
            raise ValueError(
                "delta refresh requested but an engine's geometry no "
                "longer matches the live tables (vocab grew) — use "
                "delta=None/False")
        dirty = self._take_dirty()
        full_refresh = delta is False or not can_delta
        if not full_refresh:
            # adaptive models: hold the apply lock across gather → defer →
            # flush, or a retrain install landing in between would be
            # overwritten by the pre-retrain rows gathered here
            guard = (self._apply_lock if self._adaptive
                     else contextlib.nullcontext())
            try:
                with guard:
                    self._ship_deltas(online, dirty)
            except ValueError:
                # the vocabulary grew after the geometry check: fall back
                # (refresh drops what was deferred)
                if delta is True:
                    raise
                full_refresh = True
        if full_refresh:
            with self._apply_lock:
                snapshot = self.model.to_model()
            for engine in self._engines:
                engine.refresh(snapshot)
        # per-partition swap provenance: each driver stamps its partition's
        # watermark onto every engine's fresh version
        for engine in self._engines:
            for d in self.drivers.values():
                d._note_swap(engine.version, d.consumed_offset,
                             source="stream_refresh")

    def _ship_deltas(self, online, dirty: dict) -> None:
        """Each partition's dirty rows into every engine as deferred
        deltas, then one flush per engine. Raises ``ValueError`` when the
        vocabulary grew past an engine's geometry."""
        for p, (du, di) in sorted(dirty.items()):
            ua = (np.fromiter(du, np.int64, len(du)) if du
                  else np.zeros(0, np.int64))
            ia = (np.fromiter(di, np.int64, len(di)) if di
                  else np.zeros(0, np.int64))
            with self._apply_lock:
                # the id → row map and the row values under the model lock
                # (a concurrent ensure rebuilds the sorted index)
                u_rows, _ = online.users.rows_for(ua)
                i_rows, _ = online.items.rows_for(ia)
                U_vals = online.users.gather_rows(u_rows)
                V_vals = online.items.gather_rows(i_rows)
            for engine in self._engines:
                engine.apply_delta(item_rows=i_rows, V_rows=V_vals,
                                   user_rows=u_rows, U_rows=U_vals,
                                   defer=True)
        for engine in self._engines:
            engine.flush_deltas()

    # -- telemetry -----------------------------------------------------------

    def start_telemetry_export(self, interval_s: float = 5.0) -> None:
        """Per-partition timed telemetry for every member driver: keeps
        ``streams_lag_records{partition=p}`` fresh for all N partitions (a
        driver publishes its own only)."""
        for d in self.drivers.values():
            d.start_telemetry_export(interval_s)

    def stop_telemetry_export(self) -> None:
        for d in self.drivers.values():
            d.stop_telemetry_export()

    def telemetry(self) -> dict:
        """Aggregate and per-partition snapshot."""
        per_part = {p: d.telemetry() for p, d in self.drivers.items()}
        out = {
            "partitions": sorted(self.partitions),
            "consumers": len(self.drivers),
            "batches_processed": sum(t["batches_processed"]
                                     for t in per_part.values()),
            "records_processed": sum(t["records_processed"]
                                     for t in per_part.values()),
            "lag_records": {p: t["lag_records"]
                            for p, t in per_part.items()},
            "consumed_offsets": {p: t["consumed_offset"]
                                 for p, t in per_part.items()},
            "checkpoints_written": self.checkpoints_written,
            "barriers_held": self.barriers_held,
            "refreshes_coalesced": self.refreshes_coalesced,
            "catalog_versions": list(self.catalog_versions),
            "per_partition": per_part,
        }
        if self.gate is not None:
            out["gate"] = {"grants": self.gate.grants,
                           "waits": self.gate.waits}
        return out
