"""The serving engine: sustained-throughput top-K over a versioned catalog
(counterpart of ``large_scale_recommendation_tpu.serving.engine``).

``MFModel.recommend`` is a per-call surface. ``ServingEngine`` is the
serving loop around one model snapshot:

- **request micro-batching** — ``submit`` queues user rows across
  requests; ``flush`` packs them into micro-batches of at most
  ``max_batch`` rows, each padded to a pow2 bucket, so the stream runs
  against a bounded shape family (``utils.shapes.pow2_buckets``);
  ``recommend`` serves one request, ``serve`` a request iterable.
- **versioned catalog** — the engine serves from its own copies of the
  tables, stamped with ``parallel.serving.catalog_version``; ``refresh()``
  rebinds to the current (or a new) model, ``apply_delta`` installs only
  touched rows (out of place, so the version moves), ``defer=True`` +
  ``flush_deltas()`` coalesce many deltas into one swap.
- **bf16 catalog** (``dtype="bfloat16"``) — scores still accumulate in
  f32.
- **two-deep dispatch** — micro-batches run two deep
  (``parallel.serving.run_pipelined_topk``): host exclusion building and
  pinned staging of chunk i+1 overlap device scoring of chunk i.
- **two-stage fast path** (``retrieval=RetrievalConfig(...)``) — int8
  stage 1, exact f32 stage 2 (``serving.retrieval``).
- **admission control** (``admission=AdmissionController(...)``) — the
  SLO burn drives widen → degrade (stage-1-only, flagged) → shed
  (``serving.admission``).

- **store-backed user side** (``user_store=``, a ``store
  .TieredFactorStore`` that IS the bound model's user table): the engine
  holds no user table; each micro-batch's user rows come through
  ``serve_rows`` (hot slots from the device pool, misses from the cold
  tier), so a tier miss's transfer lands inside the flush.

The engine's tensors live on ``model.device``: a model on the card serves
on the card, a CPU model on the CPU; there is no other route. With
``mesh=`` (a ``parallel.partitioner.Partitioner``) the exact path serves
over the mesh: the catalog is sharded over the ranks
(``parallel.serving.shard_catalog``), each micro-batch runs
``mesh_topk_step`` (local top-k, candidates gathered over the ring, one
more top-k), on the partitioner's device; every rank holds the user table
and calls the engine with the same requests (the step is collective). The
two-stage path over a mesh is each rank's own replicated retriever (the
JAX package's single-host layout); a rank-sharded one (``model_parallel >
1``) raises ``NotImplementedError`` (ROADMAP.md queue A).

Observability binds at construction, as in the JAX package: the registry
histograms (``serving_queue_wait_s``, ``serving_batch_assembly_s``,
``serving_flush_s``, ``serving_score_s{bucket=}``), a ``serving/flush``
span per flush (compile-keyed on the catalog geometry) and a
``serving/catalog_swap`` instant per swap, the journal's
``serving.catalog_swap`` / ``serving.catalog_delta`` events, the
transfer ledger's ``serving.delta`` note, and the serving and stream
planes: every swap stamps one lineage record (inside the engine lock, so
records land in swap order), every flush joins its version back
(``LineageJournal.observe_serve``, ``CriticalPathAnalyzer.note_serve``),
attributes each request's latency to its version's rollout cohort
(``RolloutBudget.note_results``) and closes a stage ledger
(``RequestTelemetry.note_flush``); a shed submit notes both planes. The
version keys are the engine's own token (``version``). Every plane is one
``is not None`` test per seam when off. The stage marks are host clocks:
the card's time of a chunk lands in ``topk_merge``, marked in the drain
after the chunk's copy event is waited on (``obs.requests``). The scoring
pipeline runs inside the transfer guard's ``serving.serve_rows`` scope, as
in the JAX engine: its staging copies are pinned and non-blocking, and its
host reads are the drains, each an event wait on its chunk's copy, which
the sync-debug mode does not count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.models.mf import (
    MFModel,
    _assemble_topk,
)
from large_scale_recommendation_tpu_torch.obs.budget import get_budget
from large_scale_recommendation_tpu_torch.obs.contention import named_rlock
from large_scale_recommendation_tpu_torch.obs.disttrace import get_disttrace
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.lineage import get_lineage
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.requests import get_requests
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer
from large_scale_recommendation_tpu_torch.obs.transfers import (
    get_transfers,
    guard_scope,
)
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    as_partitioner,
)
from large_scale_recommendation_tpu_torch.parallel.serving import (
    _catalog_dtype,
    catalog_version,
    run_pipelined_topk,
    mesh_topk_step,
    shard_catalog,
    to_device,
    topk_step,
)
from large_scale_recommendation_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionRejectedError,
)
from large_scale_recommendation_tpu_torch.serving.retrieval import (
    RetrievalConfig,
    TwoStageRetriever,
)
from large_scale_recommendation_tpu_torch.utils.metrics import (
    ThroughputMeter,
    _exclusion_builder,
)
from large_scale_recommendation_tpu_torch.utils.shapes import (
    pow2_buckets,
    pow2_pad,
)


class RecResult(tuple):
    """One request's result: unpacks like ``(ids, scores)`` /
    ``(ids, scores, mask)``, plus ``catalog_version`` (the build that
    answered) and ``degraded`` (stage-1-only admission fallback)."""

    catalog_version: int
    degraded: bool

    def __new__(cls, parts, catalog_version: int, degraded: bool = False):
        self = tuple.__new__(cls, parts)
        self.catalog_version = int(catalog_version)
        self.degraded = bool(degraded)
        return self


class ServingEngine:
    """Micro-batching top-K engine over one model snapshot.

    ``model`` (an ``MFModel``), ``k`` results per user, ``train`` (a
    ``Ratings`` or ``(user_ids, item_ids)`` exclusion set, as
    ``MFModel.recommend``), ``dtype`` (``"bfloat16"``: half-width catalog),
    ``max_batch`` / ``min_bucket`` (the pow2 bucket policy), ``slo`` (an
    ``obs.health.SLOTracker``: every flushed request's latency, queue wait
    plus synced flush wall, is recorded), ``retrieval`` (a
    ``RetrievalConfig`` or ``"two_stage"``), ``admission`` (an
    ``AdmissionController``), ``user_store`` (a tiered store sharing the
    model's user row space: its rows are served in place of ``model.U``).

    Results follow ``recommend``: int64 ids, unknown users → -1/0.0 rows,
    below-catalog slots → -1/0.0. ``submit``/``flush``/``refresh`` hold one
    lock, so every flush serves from one catalog version."""

    def __init__(self, model: MFModel, k: int = 10, mesh=None,
                 train=None, dtype=None, max_batch: int = 1024,
                 min_bucket: int = 8, slo=None, retrieval=None,
                 admission: AdmissionController | None = None,
                 user_store=None):
        self.partitioner = (None if mesh is None
                            else as_partitioner(mesh))
        self._user_store = user_store
        if max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {max_batch}")
        if min_bucket & (min_bucket - 1) or not 0 < min_bucket <= max_batch:
            raise ValueError(f"min_bucket must be a power of two in "
                             f"[1, max_batch], got {min_bucket}")
        self.k = int(k)
        if retrieval == "two_stage":
            retrieval = RetrievalConfig()
        if retrieval is not None and not isinstance(retrieval,
                                                    RetrievalConfig):
            raise TypeError(f"retrieval must be a RetrievalConfig or "
                            f"'two_stage', got {type(retrieval).__name__}")
        self._retrieval_cfg: RetrievalConfig | None = retrieval
        self._retriever: TwoStageRetriever | None = None
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        # the static shape family requests dispatch against
        self.bucket_family = pow2_buckets(min_bucket, max_batch)
        self._dtype = _catalog_dtype(dtype)
        self._train = train
        self._pending: list[np.ndarray] = []
        self._pending_t: list[float] = []  # submit stamps (queue wait)
        # raw unless the contention plane is armed: then the engine's
        # submit / flush / refresh serialization publishes as
        # lock_*{lock="serving.engine"}
        self._lock = named_rlock("serving.engine")
        self.stats = {"requests": 0, "rows": 0, "microbatches": 0,
                      "flushes": 0, "refreshes": 0, "delta_swaps": 0,
                      "deferred_delta_rows": 0, "delta_flushes": 0,
                      "buckets": {}}
        # apply_delta(defer=True) buffers: (rows, f32 values on the
        # engine's device) in arrival order; the newest value of a row wins
        self._pending_items: list[tuple[np.ndarray, torch.Tensor]] = []
        self._pending_users: list[tuple[np.ndarray, torch.Tensor]] = []
        self._shapes_seen: set[tuple] = set()  # exact path's dispatches
        self.meter = ThroughputMeter()
        # observability binds at construction (null singletons / None when
        # off), before the constructor's refresh so the first build is
        # stamped too
        obs = get_registry()
        self._obs = obs
        self._obs_on = obs.enabled
        self._trace = get_tracer()
        self._events = get_events()
        self._lineage = get_lineage()
        self._disttrace = get_disttrace()
        self._budget = get_budget()
        self._requests = get_requests()
        self._m_qwait = obs.histogram("serving_queue_wait_s")
        self._m_assembly = obs.histogram("serving_batch_assembly_s")
        self._m_flush = obs.histogram("serving_flush_s")
        self._m_requests = obs.counter("serving_requests_total")
        self._m_rows = obs.counter("serving_rows_total")
        # an admission controller brings its own tracker: without a
        # separate slo= the engine records into it (adopted), so the
        # burn the ladder reads is the burn this engine produces
        self._admission = admission
        self._slo_adopted = slo is None and admission is not None
        if self._slo_adopted:
            slo = admission.slo
        self._slo = slo
        # swap hook: on_refresh(version) after every refresh/delta, under
        # the engine lock (so versions are reported in swap order)
        self.on_refresh = None
        self.refresh(model)

    # -- catalog lifecycle ---------------------------------------------------

    def refresh(self, model: MFModel | None = None) -> int:
        """(Re)bind the engine to ``model`` (default: the current one, as
        it is now): new copies of its tables, a new version token (a table
        written in place since the last build gets a fresh one), deferred
        deltas dropped. Returns the version (reported to ``on_refresh``)."""
        swap_detail = None
        with self._lock:
            version = self._refresh(model)
            hook = self.on_refresh
            if hook is not None:
                hook(version)
            if self._lineage is not None:
                # the swap instant; the driver / adaptive layers enrich
                # the same record by version
                self._lineage.record_swap(version, source="engine_refresh")
            if self._events is not None:
                swap_detail = {"version": version,
                               "refreshes": self.stats["refreshes"],
                               "rows": int(self.catalog_rows)}
        if swap_detail is not None:
            # journaled outside the engine lock (the emit may write the
            # journal's JSONL mirror)
            self._events.emit("serving.catalog_swap", **swap_detail)
        return version

    def _refresh(self, model: MFModel | None) -> int:
        if model is not None:
            self.model = model
        model = self.model
        # a full rebuild supersedes anything still deferred
        self._pending_items.clear()
        self._pending_users.clear()
        self._item_ids_of_row = np.asarray(model.items.ids)
        item_mask = self._item_ids_of_row >= 0
        part = self.partitioner
        V = model.V if part is None else model.V.to(part.device)
        if self._retrieval_cfg is not None:
            # int8 stage 1 + f32 rescore; dtype= does not apply
            self._catalog = None
            self._retriever = TwoStageRetriever(
                V, item_mask=item_mask, config=self._retrieval_cfg,
                partitioner=part)
            want = torch.float32
        else:
            self._catalog = shard_catalog(V, part, item_mask=item_mask,
                                          dtype=self._dtype)
            rpb = self._catalog.rows_per_shard
            self._k_local = min(self.k, rpb)
            self._k_out = min(self.k, (1 if part is None else
                                       part.num_blocks) * self._k_local)
            want = self._dtype
        self._want = want
        self._device = V.device
        if self._user_store is not None:
            # no engine-held user table: the store is the live user state
            self._U = None
            n_users = int(self._user_store.num_rows)
        else:
            # the engine's own copy
            self._U = model.U.to(self._device, want, copy=True)
            n_users = int(model.U.shape[0])
        tu, ti = model._train_rows(self._train)
        self._build_excl = _exclusion_builder(tu, ti, n_users)
        self.stats["refreshes"] += 1
        if self._obs_on:
            # version-labeled: which builds reached this engine
            self._obs.counter("serving_catalog_swaps_total",
                              version=self.version).inc()
            self._obs.gauge("serving_catalog_version").set(self.version)
            self._trace.instant("serving/catalog_swap",
                                version=self.version)
        return self.version

    def apply_delta(self, item_rows=None, V_rows=None,
                    user_rows=None, U_rows=None,
                    defer: bool = False) -> int:
        """Install ONLY the touched factor rows: ``*_rows`` index the bound
        model's row space (vocab growth is a full ``refresh``, a row past
        it raises ``ValueError``), ``V_rows`` / ``U_rows`` are the rows'
        new f32 factors. The bound model's tables are replaced by patched
        copies (so a later ``refresh()`` keeps the delta), the catalog
        version moves, and the fast path re-quantizes exactly the dirty
        rows. The values may be host arrays or tensors (a tensor on the
        engine's device is never copied through the host). Returns the new
        version (reported to ``on_refresh``).

        ``defer=True`` buffers the rows (newest value per row wins) until
        ``flush_deltas()`` installs everything pending as ONE swap,
        bit-equal to applying each delta eagerly in arrival order; returns
        the unchanged current version."""
        if self._user_store is not None:
            # serve_rows reads the store itself: nothing to install on the
            # user side (shipped copies could only go backwards)
            user_rows, U_rows = None, None
        with self._lock:
            sides = self._delta_sides(item_rows, V_rows, user_rows, U_rows)
            if defer:
                for rows, vals, side in sides:
                    pending = (self._pending_items if side == "item"
                               else self._pending_users)
                    pending.append((rows, vals))
                    self.stats["deferred_delta_rows"] += len(rows)
                return self.version
            model, dev = self.model, self._device
            ledger = get_transfers()
            for rows, vals, side in sides:
                if ledger is not None:
                    # the delta's rows reached the engine's device in
                    # _delta_sides (async from pinned memory: wait 0.0)
                    ledger.note_transfer("serving.delta", "h2d",
                                         vals.numel() * vals.element_size())
                idx = to_device(rows.astype(np.int64), dev)
                if side == "item":
                    model.V = model.V.index_copy(0, idx,
                                                 vals.to(model.V.dtype))
                    version = catalog_version(model.V)
                    if self._catalog is not None:
                        self._catalog = self._catalog.apply_delta(
                            rows, vals, version=version)
                    else:
                        self._retriever.apply_delta(rows, vals, version)
                else:
                    model.U = model.U.index_copy(0, idx,
                                                 vals.to(model.U.dtype))
                    self._U = self._U.index_copy(0, idx,
                                                 vals.to(self._U.dtype))
            self.stats["delta_swaps"] += 1
            version = self.version
            hook = self.on_refresh
            if hook is not None:
                hook(version)
            if self._obs_on:
                self._obs.counter("serving_catalog_delta_total").inc()
                self._obs.gauge("serving_catalog_version").set(version)
            if self._lineage is not None:
                self._lineage.record_swap(version, source="engine_delta")
            swap_detail = None
            if self._events is not None:
                swap_detail = {
                    "version": version,
                    "item_rows": int(sum(len(r) for r, _, sd in sides
                                         if sd == "item")),
                    "user_rows": int(sum(len(r) for r, _, sd in sides
                                         if sd == "user")),
                    "delta_swaps": self.stats["delta_swaps"]}
        if swap_detail is not None:
            self._events.emit("serving.catalog_delta", **swap_detail)
        return version

    def _delta_sides(self, item_rows, V_rows, user_rows, U_rows) -> list:
        """The non-empty sides of a delta as ``(rows, f32 values on the
        engine's device, side)``, every row checked against the bound model
        first (vocab growth is a full refresh), so a rejected delta touches
        neither side."""
        sides = []
        for rows, vals, side, table in (
                (item_rows, V_rows, "item", self.model.V),
                (user_rows, U_rows, "user", self.model.U)):
            if rows is None or not len(rows):
                continue
            rows = np.asarray(rows)
            if rows.max() >= table.shape[0]:
                raise ValueError(
                    f"delta {side} row {int(rows.max())} outside the "
                    f"{int(table.shape[0])} {side} rows of the bound model "
                    f"— vocab grew; use refresh()")
            if isinstance(vals, torch.Tensor):
                vals = vals.to(self._device, torch.float32)
            else:
                vals = to_device(np.asarray(vals, np.float32), self._device)
            sides.append((rows, vals, side))
        return sides

    def flush_deltas(self) -> int:
        """Install every ``apply_delta(defer=True)`` row pending as ONE
        swap (no-op when nothing is pending); returns the version serving
        now runs on. The lock is held across take and install, so a
        ``refresh()`` cannot land in between and be overwritten by stale
        rows."""
        with self._lock:
            items, self._pending_items = self._pending_items, []
            users, self._pending_users = self._pending_users, []
            if not items and not users:
                return self.version
            self.stats["delta_flushes"] += 1

            def pack(pending):
                if not pending:
                    return None, None
                rows = np.concatenate([r for r, _ in pending])
                # the last occurrence of each row: its newest value
                _, first_from_end = np.unique(rows[::-1], return_index=True)
                keep = len(rows) - 1 - first_from_end
                vals = torch.cat([v for _, v in pending])
                return rows[keep], vals[torch.as_tensor(keep,
                                                        device=vals.device)]

            i_rows, i_vals = pack(items)
            u_rows, u_vals = pack(users)
            return self.apply_delta(item_rows=i_rows, V_rows=i_vals,
                                    user_rows=u_rows, U_rows=u_vals)

    @property
    def pending_delta_rows(self) -> int:
        """Rows buffered by ``apply_delta(defer=True)``."""
        with self._lock:
            return sum(len(np.unique(np.concatenate([r for r, _ in p])))
                       for p in (self._pending_items, self._pending_users)
                       if p)

    @property
    def version(self) -> int:
        """The bound catalog's version token (``catalog_version``)."""
        if self._catalog is not None:
            return self._catalog.version
        return self._retriever.version

    @property
    def admission(self) -> AdmissionController | None:
        return self._admission

    @property
    def retriever(self) -> TwoStageRetriever | None:
        """The fast path's ``TwoStageRetriever`` (None on the exact
        path)."""
        return self._retriever

    @property
    def catalog_rows(self) -> int:
        if self._catalog is not None:
            return self._catalog.n_rows
        return self._retriever.n_rows

    @property
    def executable_variants(self) -> int:
        """Distinct ``(path, bucket, width)`` shapes dispatched: grows with
        the bucket family, not the request count (no jit here, so this
        counts the shapes the JAX package would compile)."""
        if self._retriever is not None:
            return len(self._retriever.buckets_seen)
        return len(self._shapes_seen)

    def attach_admission(self, controller: AdmissionController) -> None:
        """Arm (or swap) admission control on a live engine. Unless the
        constructor was given its own ``slo=``, the controller's tracker
        becomes the engine's, on a swap too."""
        with self._lock:
            self._admission = controller
            if controller is not None and (self._slo is None
                                           or self._slo_adopted):
                self._slo = controller.slo
                self._slo_adopted = True

    # -- request intake ------------------------------------------------------

    def submit(self, user_ids) -> int:
        """Queue one request; returns its index into ``flush()``'s result
        list. At the ``shed`` level this raises ``AdmissionRejectedError``;
        queued requests still flush."""
        if self._admission is not None:
            try:
                self._admission.check_admit()  # raises when shedding
            except AdmissionRejectedError as e:
                if self._budget is not None:
                    # charged to the version that would have served
                    self._budget.note_shed(self.version)
                if self._requests is not None:
                    # a shed is a tail exemplar: always kept
                    self._requests.note_shed(
                        version=self.version, level=e.level, burn=e.burn,
                        queue_depth=len(self._pending))
                raise
        with self._lock:
            self._pending.append(np.asarray(user_ids))
            self._pending_t.append(time.perf_counter())
            return len(self._pending) - 1

    def recommend(self, user_ids, return_mask: bool = False):
        """Serve one request now (submit + flush under one lock hold, so a
        concurrent caller cannot drain this ticket). Requests queued
        before it are served in the same pass."""
        with self._lock:
            idx = self.submit(user_ids)
            return self.flush(return_mask=return_mask)[idx]

    def serve(self, requests, return_mask: bool = False) -> list:
        """Serve an iterable of requests, rows of adjacent requests packed
        into shared micro-batches. One result per request, in order: a
        ``RecResult``, or the ``AdmissionRejectedError`` instance of a
        request the ladder shed. Requests queued before the call are
        served but not returned."""
        with self._lock:
            out: list = []
            next_fill = 0  # first not-yet-filled placeholder in out
            queued_rows = 0
            skip = len(self._pending)  # pre-queued tickets: not ours

            def drain():
                nonlocal skip, queued_rows, next_fill
                for res in self.flush(return_mask=return_mask)[skip:]:
                    while out[next_fill] is not None:
                        next_fill += 1  # skip shed markers
                    out[next_fill] = res
                skip = 0
                queued_rows = 0

            for r in requests:
                r = np.asarray(r)
                try:
                    self.submit(r)
                    out.append(None)  # filled by the covering flush
                    queued_rows += len(r)
                except AdmissionRejectedError as e:
                    out.append(e)
                    continue
                # at widen the flush threshold stretches to
                # widen_factor × max_batch rows
                limit = self.max_batch
                if self._admission is not None:
                    limit = int(limit * self._admission.widen_factor)
                if queued_rows >= limit:
                    drain()
            if self._pending:
                drain()
            return out

    # -- execution -----------------------------------------------------------

    def flush(self, return_mask: bool = False) -> list:
        """Run every queued request through bucketed micro-batches and
        return their ``RecResult``s in submit order, all from one catalog
        version."""
        with self._lock:
            requests, self._pending = self._pending, []
            if not requests:
                return []
            # read once per flush: a flush is uniformly exact or degraded
            degraded = (self._admission is not None
                        and self._admission.degrade_active
                        and self._retriever is not None)
            t0 = time.perf_counter()
            stamps, self._pending_t = self._pending_t, []
            # the stage ledger is anchored on the flush wall's own t0
            # (None when the request plane is off: no allocation)
            led = (self._requests.ledger(t0)
                   if self._requests is not None else None)
            if self._obs_on:
                for ts in stamps:
                    self._m_qwait.observe(t0 - ts)
            # id → row space per request, then one shared row stream
            with self._trace.span("serving/lookup") as sp:
                known_masks, row_slices, bounds = [], [], [0]
                for ids in requests:
                    u_rows, u_mask = self.model.users.rows_for(ids)
                    known = u_mask > 0
                    known_masks.append((len(ids), known))
                    row_slices.append(u_rows[known])
                    bounds.append(bounds[-1] + int(known.sum()))
                rows_all = (np.concatenate(row_slices) if row_slices
                            else np.zeros(0, np.int64))
                sp.note(users=len(rows_all))
            if self._obs_on or led is not None:
                # one clock read feeds the assembly histogram and the
                # ledger's batch_form mark
                t_asm = time.perf_counter()
                if self._obs_on:
                    self._m_assembly.observe(t_asm - t0)
                if led is not None:
                    led.mark("batch_form", t_asm)
            # compile-keyed on the catalog geometry, as the JAX span;
            # catalog_version is the record trace's serve-side join
            geom = (self._catalog.rows_per_shard
                    if self._catalog is not None
                    else self._retriever.n_rows)
            with self._trace.span(
                    "serving/flush", key=("serving_flush", geom),
                    rows=len(rows_all), requests=len(requests),
                    catalog_version=int(self.version)):
                top_rows, top_scores = self._serve_rows(
                    rows_all, stage1_only=degraded, ledger=led)
            version = self.version
            with self._trace.span("serving/assemble"):
                results = []
                for (n_ids, known), b0, b1 in zip(known_masks, bounds,
                                                  bounds[1:]):
                    results.append(RecResult(
                        _assemble_topk(n_ids, self.k, known,
                                       top_rows[b0:b1], top_scores[b0:b1],
                                       self._item_ids_of_row, return_mask),
                        catalog_version=version, degraded=degraded))
            self.stats["requests"] += len(requests)
            self.stats["rows"] += len(rows_all)
            self.stats["flushes"] += 1
            wall = time.perf_counter() - t0
            end = t0 + wall
            # the level that served this flush, read before observe()
            adm_level = (self._admission.level
                         if self._admission is not None else None)
            self.meter.record(len(rows_all), wall)
            if self._slo is not None:
                # one sample per REQUEST: queue wait + flush wall
                for ts in stamps:
                    self._slo.record(end - ts)
            if self._admission is not None:
                if degraded:
                    self._admission.count_degraded(len(requests))
                self._admission.observe()
            if self._obs_on:
                # results are host arrays by here: a synced wall
                self._m_flush.observe(wall)
                self._m_requests.inc(len(requests))
                self._m_rows.inc(len(rows_all))
        # the planes' flush notes, outside this flush's own lock hold (the
        # recommend() path still holds the re-entrant lock): the lineage
        # join and the critical-path note only try their locks, the budget
        # and request planes hold their own short locks
        if self._lineage is not None:
            self._lineage.observe_serve(version, requests=len(requests))
        if self._disttrace is not None:
            self._disttrace.note_serve(version)
        if self._budget is not None:
            self._budget.note_results(
                version, [end - ts for ts in stamps],
                degraded=len(requests) if degraded else 0)
        if led is not None:
            # the same end / stamps floats the SLO recorded close the
            # ledger, so each request's stage sum reconciles by
            # construction
            self._requests.note_flush(
                led, end, stamps, version=version, degraded=degraded,
                rows=[b1 - b0 for b0, b1 in zip(bounds, bounds[1:])],
                admission_level=adm_level)
        return results

    def _serve_rows(self, user_rows: np.ndarray, stage1_only: bool = False,
                    ledger=None):
        """Row-space scoring through pow2-bucketed micro-batches on the
        two-deep pipeline (``run_pipelined_topk``): the exact step or the
        two-stage fast path (``stage1_only``: the degraded point). Per
        chunk the host builds the exclusion triple and stages it with the
        user rows through pinned memory; nothing in a chunk's dispatch
        reads back. ``ledger`` (an ``obs.requests.FlushLedger``, None when
        the plane is off) marks the stage seams: exclusion builds in
        ``batch_form``, user gathers in ``gather``, score dispatches in
        ``score_stage1`` / ``score_stage2``, drains in ``topk_merge``. The
        same seams are spans: ``serving/exclusions`` (arg ``pairs``, the
        staged exclusion slots), ``serving/gather``, ``serving/score`` and
        ``run_pipelined_topk``'s ``serving/drain``."""
        dev = self._device
        store = self._user_store
        trace = self._trace

        def stage(cu, c):
            with trace.span("serving/exclusions") as sp:
                built = self._build_excl(cu, c)
                excl = tuple(to_device(a, dev) for a in built)
                sp.note(pairs=len(built[0]))
            if ledger is not None:
                ledger.mark("batch_form")  # exclusion build + staging
            with trace.span("serving/gather"):
                if store is not None:
                    U_chunk = store.serve_rows(cu).to(self._want)
                else:
                    idx = to_device(cu.astype(np.int64), dev)
                    U_chunk = self._U.index_select(0, idx)
            if ledger is not None:
                ledger.mark("gather")
            return excl, U_chunk

        if self._retriever is not None:
            ret = self._retriever

            def score_chunk(cu, c):
                excl, U_chunk = stage(cu, c)
                with trace.span("serving/score"):
                    return ret.topk(U_chunk, excl, k=self.k,
                                    stage1_only=stage1_only,
                                    mark=(ledger.mark if ledger is not None
                                          else None))

            k_out = min(self.k, ret.candidate_count(self.k))
            n_rows = ret.n_rows
            slice_size = min(self.max_batch, ret.config.max_bucket)
        else:
            cat, part = self._catalog, self.partitioner

            def score_chunk(cu, c):
                excl, U_chunk = stage(cu, c)
                self._shapes_seen.add(("exact", len(cu), self._k_out))
                with trace.span("serving/score"):
                    if part is not None:
                        out = mesh_topk_step(
                            part, U_chunk, cat.V_sh, cat.w_sh, *excl,
                            k_local=self._k_local, k_out=self._k_out,
                            rows_per_shard=cat.rows_per_shard)
                    else:
                        out = topk_step(U_chunk, cat.V_sh, cat.w_sh, *excl,
                                        k_out=self._k_out)
                if ledger is not None:
                    # the exact path's one score dispatch: stage 1
                    ledger.mark("score_stage1")
                return out

            k_out, n_rows, slice_size = (self._k_out, cat.n_rows,
                                         self.max_batch)

        if self._obs_on:
            base_chunk = score_chunk

            def score_chunk(cu, c):
                # per-bucket host wall of staging + dispatch (the card's
                # time is in the flush histogram: blocking per chunk would
                # serialize the pipeline's overlap)
                t0 = time.perf_counter()
                out = base_chunk(cu, c)
                bucket = len(cu)
                self._obs.histogram("serving_score_s", bucket=bucket
                                    ).observe(time.perf_counter() - t0)
                self._obs.gauge("serving_bucket_occupancy",
                                bucket=bucket).set(c / bucket)
                return out

        def on_batch(bucket):
            self.stats["microbatches"] += 1
            hist = self.stats["buckets"]
            hist[bucket] = hist.get(bucket, 0) + 1
            if self._obs_on:
                self._obs.counter("serving_microbatches_total",
                                  bucket=bucket).inc()

        with guard_scope("serving.serve_rows"):
            return run_pipelined_topk(
                user_rows, k=self.k, k_out=k_out, n_rows=n_rows,
                slice_size=slice_size,
                bucket_fn=lambda c: min(pow2_pad(c, self.min_bucket),
                                        slice_size),
                score_chunk=score_chunk, on_batch=on_batch,
                on_drain=(None if ledger is None
                          else lambda: ledger.mark("topk_merge")))
