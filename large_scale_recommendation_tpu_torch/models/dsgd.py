"""DSGD: Gemulla-style stratified SGD matrix factorization (counterpart of
``large_scale_recommendation_tpu.models.dsgd``).

Two data paths feed the same training loop:

- ``fit``: external ids, blocked by a one-time host pass
  (``data.blocking``); the tables and the blocked ratings then live on the
  solver's device for the whole run;
- ``fit_device``: dense ids, blocked on the solver's device
  (``data.device_blocking``); only the id→row maps come back to the host.

``factor_dtype="bfloat16"`` keeps the tables in bf16 at rest. On the card
the kernels round once per stratum (the TPU kernels' once per block
visit); the CPU route rounds once per ``dsgd_train`` call (the JAX XLA
route). The two routes therefore legitimately differ in bf16.

Routing follows the device, not a config field (the port's ``DSGDConfig``
has no ``kernel``):

- on a CUDA device ``fit`` always runs the hand-written stratum-sweep
  kernels (``ops.cuda_sgd.dsgd_train_cuda``). They inline the λ/ω
  ``RegularizedSGDUpdater`` rule and the precomputed collision scales, so
  any other updater, ``collision_mode`` or ``precompute_collisions=False``
  raises ``ValueError``;
- on the CPU ``fit`` runs the plain PyTorch route (``ops.sgd.dsgd_train``)
  with the full ``collision_mode`` semantics.

Checkpoints (``utils.checkpoint``): with a ``checkpoint_manager`` each
segment of ``checkpoint_every`` sweeps ends in a snapshot of the tables,
tagged with the fit path; ``resume=True`` picks up from the latest one.
Blocking, init and the step plan are deterministic, and the kernels have no
atomics, so a resumed fit is bit-equal to an uninterrupted one.

Observability (``obs.enable()`` before the solver is built): each segment
runs inside a ``TrainSegmentTimer("dsgd", kind)`` (``train_segment_s``, a
compile-keyed ``train/dsgd`` span that waits for the segment's CUDA work)
and the ``"dsgd.fit"`` transfer-guard scope, and emits ``train.segment``
/ ``train.checkpoint`` events when a journal is installed; the fit ends
with the throughput gauges and, on the card, the step pair's byte model
registered with the introspector. Disabled, none of it reads a clock or
touches the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
    RandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.core.updaters import (
    RegularizedSGDUpdater,
    schedule_from_name,
)
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data import device_blocking
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.instrument import (
    TrainSegmentTimer,
)
from large_scale_recommendation_tpu_torch.obs.trace import span
from large_scale_recommendation_tpu_torch.obs.transfers import guard_scope
from large_scale_recommendation_tpu_torch.ops import cuda_sgd
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    restore_segment_state,
)
from large_scale_recommendation_tpu_torch.utils.device import resolve_device

_FACTOR_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DSGDConfig:
    num_factors: int = 10
    lambda_: float = 1.0
    iterations: int = 10
    num_blocks: int | None = None  # None → 1
    learning_rate: float = 0.001
    # any core.updaters.schedule_from_name name
    lr_schedule: str = "inverse_sqrt"
    seed: int | None = 0
    minibatch_size: int = 1024
    init_scale: float = 1.0  # factor init upper bound
    collision_mode: str = "mean"  # minibatch row-collision handling (ops.sgd)
    # precompute the "mean"-mode collision scales at blocking time
    precompute_collisions: bool = True
    # intra-minibatch ordering ("user"|"item"|None): locality only, same math
    minibatch_sort: str | None = None
    # factor table storage: "float32" | "bfloat16" (f32 accumulation)
    factor_dtype: str = "float32"

    def schedule_fn(self):
        return schedule_from_name(self.lr_schedule, self.lambda_)

    def storage_dtype(self) -> torch.dtype:
        if self.factor_dtype not in _FACTOR_DTYPES:
            raise ValueError(
                f"factor_dtype {self.factor_dtype!r} unsupported; "
                "float32 or bfloat16")
        return _FACTOR_DTYPES[self.factor_dtype]


class DSGD:
    """Batch DSGD solver. ``device=None`` runs on the card."""

    def __init__(self, config: DSGDConfig | None = None, updater: Any = None,
                 device=None):
        self.config = config or DSGDConfig()
        self.device = resolve_device(device)
        self.updater = updater or RegularizedSGDUpdater(
            learning_rate=self.config.learning_rate,
            lambda_=self.config.lambda_,
            schedule=self.config.schedule_fn(),
        )
        self.model: MFModel | None = None
        # segment-boundary hooks (``after_segment(U, V, label=)`` and
        # ``on_segment(U, V, label=, step=)``), run before the snapshot;
        # None = one pointer test per segment
        self.watchdog = None
        self.evaluator = None
        # device ms of each training segment of the last fit (CUDA events
        # around the segment's launches; hooks and snapshots excluded);
        # empty on the CPU
        self.segment_ms: list[float] = []
        # seconds the card took to build the last fit's step plan (CUDA
        # events, read after the fit's last wait; card only)
        self.plan_s: float | None = None
        self._plan_events: tuple | None = None
        # the last fit's step plan (card only): the introspector's byte
        # model counts its rows
        self._plan: cuda_sgd.StepPlan | None = None
        # structured event journal (obs.events), bound at construction:
        # None = one pointer test per segment
        self._events = get_events()

    # -- fit ---------------------------------------------------------------

    def fit(self, ratings: Ratings, num_blocks: int | None = None,
            checkpoint_manager=None, checkpoint_every: int | None = None,
            resume: bool = False) -> MFModel:
        """Train. ``checkpoint_every`` runs the sweeps in segments of that
        many iterations (the schedule continues across segments); with a
        ``checkpoint_manager`` each segment ends in a snapshot (kind
        ``"dsgd_segment"``), and ``resume=True`` continues from the latest
        one (the same ratings, seed, rank and block count)."""
        cfg = self.config
        if ratings.n == 0:
            raise ValueError("cannot fit on an empty ratings set")
        k = num_blocks or cfg.num_blocks or 1
        use_inv = self._check_route()
        problem = blocking.block_problem(
            ratings,
            num_blocks=k,
            seed=cfg.seed,
            minibatch_multiple=cfg.minibatch_size,
            minibatch_sort=cfg.minibatch_sort,
        )
        U, V = self._init_factors(problem)
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(a, dtype=dtype).to(dev)

        if use_inv:
            icu, icv = blocking.minibatch_inv_counts(problem.ratings,
                                                     cfg.minibatch_size)
            inv = (put(icu, torch.float32), put(icv, torch.float32))
        else:
            inv = (None, None)
        r = problem.ratings
        args = (
            put(r.u_rows, torch.int32), put(r.i_rows, torch.int32),
            put(r.values, torch.float32), put(r.weights, torch.float32),
            put(problem.users.omega, torch.float32),
            put(problem.items.omega, torch.float32),
            *inv,
        )
        U, V = self._train_segments(put(U, torch.float32),
                                    put(V, torch.float32), args, k,
                                    "dsgd_segment", checkpoint_manager,
                                    checkpoint_every, resume,
                                    n_ratings=int(ratings.n))
        self.model = MFModel(U=U, V=V, users=problem.users,
                             items=problem.items)
        return self.model

    def fit_device(self, u, i, r, num_users: int, num_items: int,
                   num_blocks: int | None = None, checkpoint_manager=None,
                   checkpoint_every: int | None = None,
                   resume: bool = False) -> MFModel:
        """Train through the on-device data pipeline
        (``data.device_blocking``): dense ids in ``[0, num_users) ×
        [0, num_items)`` as numpy arrays or tensors; blocking, collision
        scales, init and training run on the solver's device. Init is the
        per-id keyed form (``seed=None`` blocks with seed 0). Same
        segmentation and checkpoint contract as ``fit``; snapshots are of
        kind ``"dsgd_device_segment"``."""
        cfg = self.config
        k = num_blocks or cfg.num_blocks or 1
        self._check_route()
        with span("dsgd/blocking", device=self.device.type == "cuda",
                  ratings=len(u)):
            problem = device_blocking.device_block_problem(
                u, i, r, num_users, num_items, num_blocks=k,
                minibatch_multiple=cfg.minibatch_size,
                seed=cfg.seed if cfg.seed is not None else 0,
                minibatch_sort=cfg.minibatch_sort, device=self.device)
        return self._fit_problem(problem, checkpoint_manager,
                                 checkpoint_every, resume)

    def _fit_problem(self, problem: device_blocking.DeviceBlockedProblem,
                     checkpoint_manager=None,
                     checkpoint_every: int | None = None,
                     resume: bool = False) -> MFModel:
        """Train on a device-blocked problem (the seam a test uses to train
        on a layout carried across from the JAX package)."""
        cfg = self.config
        use_inv = self._check_route()
        p = problem
        on_card = self.device.type == "cuda"
        with span("dsgd/init", device=on_card):
            U, V = self._init_factors_device(p)
        args = (p.su, p.si, p.sv, p.sw, p.omega_u, p.omega_v,
                *((p.icu, p.icv) if use_inv else (None, None)))
        U, V = self._train_segments(U, V, args, p.num_blocks,
                                    "dsgd_device_segment",
                                    checkpoint_manager, checkpoint_every,
                                    resume, n_ratings=int(p.nnz))
        with span("dsgd/id_maps", device=on_card):
            users, items = p.to_id_indices()
        self.model = MFModel(U=U, V=V, users=users, items=items)
        return self.model

    def _check_route(self) -> bool:
        """Validate the config for this device before any work; returns
        whether the precomputed collision scales are used."""
        cfg = self.config
        cfg.storage_dtype()
        use_inv = cfg.precompute_collisions and cfg.collision_mode == "mean"
        if self.device.type == "cuda":
            cuda_sgd.validate_cuda_contract(self.updater, cfg.collision_mode,
                                            use_inv)
        return use_inv

    def _train_segments(self, U, V, args, k, kind, checkpoint_manager=None,
                        checkpoint_every=None, resume=False, *,
                        n_ratings: int):
        """The segment loop: ``checkpoint_every`` sweeps per segment; at
        each boundary the hooks run, then the snapshot (tagged ``kind``).
        The tables are cast to the storage dtype first; a resume replaces
        them with the latest snapshot's, cast the same way, on the solver's
        device. ``n_ratings`` is the ratings a sweep visits (the timer's
        unit)."""
        cfg = self.config
        fdt = cfg.storage_dtype()
        U, V = U.to(fdt), V.to(fdt)
        done = 0
        if resume:
            if checkpoint_manager is None:
                raise ValueError("resume=True requires a checkpoint_manager")
            U, V, done = restore_segment_state(checkpoint_manager, kind, U, V)
        segment = checkpoint_every or cfg.iterations
        train = self._train_fn(args, k)
        timed = self.device.type == "cuda"
        events = []
        timer = TrainSegmentTimer(
            "dsgd", kind, shape_key=(tuple(U.shape), tuple(V.shape),
                                     tuple(args[0].shape)))
        while done < cfg.iterations:
            seg = min(segment, cfg.iterations - done)
            with timer.segment(seg) as h:
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                # every operand is on the device: an armed guard counts
                # any host read the segment makes
                with guard_scope("dsgd.fit"):
                    U, V = train(U, V, iterations=seg, t0=done)
                if timed:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    events.append((start, end))
                h.out = (U, V)
            done += seg
            if self.watchdog is not None:
                # before the snapshot: a tripped segment must not persist
                # its tables as a resume point
                self.watchdog.after_segment(U, V, label=kind)
            if self.evaluator is not None:
                self.evaluator.on_segment(U, V, label=kind, step=done)
            if self._events is not None:
                self._events.emit("train.segment", model="dsgd", kind=kind,
                                  iterations=int(seg), done=int(done),
                                  total=int(cfg.iterations))
            if checkpoint_manager is not None:
                checkpoint_manager.save(
                    done, {"U": U, "V": V},
                    {"kind": kind, "iterations": cfg.iterations})
                if self._events is not None:
                    self._events.emit("train.checkpoint", model="dsgd",
                                      kind=kind, step=int(done))
        if events:
            events[-1][1].synchronize()
        self.segment_ms = [a.elapsed_time(b) for a, b in events]
        if self._plan_events is not None:
            start, end = self._plan_events
            end.synchronize()  # reached already where a segment ran
            self.plan_s = start.elapsed_time(end) / 1e3
            self._plan_events = None
        rank = int(U.shape[-1])
        timer.finish(n_ratings,
                     bytes_per_iteration=self._sweep_bytes(n_ratings, rank),
                     flops_per_iteration=sgd_ops.dsgd_flops_per_sweep(
                         n_ratings, rank))
        return U, V

    def _sweep_bytes(self, n_ratings: int, rank: int) -> int:
        """The byte model of the route that ran: the step pair's
        (``kernel="cuda"``, the plan's (step, row) pairs) on the card, the
        plain route's on the CPU."""
        plan = self._plan  # built on the card only
        if plan is not None:
            return sgd_ops.dsgd_bytes_per_sweep(
                n_ratings, rank, kernel="cuda",
                user_rows=sum(plan.u_segments),
                item_rows=sum(plan.v_segments))
        return sgd_ops.dsgd_bytes_per_sweep(
            n_ratings, rank,
            factor_bytes=self.config.storage_dtype().itemsize)

    def _train_fn(self, args, k: int):
        """Route by device: the CUDA kernels on a card (``fit`` has checked
        their contract; the step plan is built here, once per fit), the
        plain route on the CPU."""
        cfg = self.config
        upd = self.updater
        if self.device.type == "cuda":
            su, si, sv, sw, _, _, icu, icv = args
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with span("dsgd/plan", device=True):
                start.record()
                plan = cuda_sgd.build_step_plan(su, si, sv, sw, icu, icv,
                                                minibatch=cfg.minibatch_size)
                end.record()
            self._plan_events = (start, end)
            self._plan = plan

            def cuda(U, V, *, iterations, t0):
                return cuda_sgd.dsgd_train_cuda(
                    U, V, *args, lr=float(upd.learning_rate),
                    lam=float(upd.lambda_), minibatch=cfg.minibatch_size,
                    num_blocks=k, iterations=iterations,
                    schedule=upd.schedule, t0=t0, plan=plan)

            return cuda

        def plain(U, V, *, iterations, t0):
            return sgd_ops.dsgd_train(
                U, V, *args, updater=upd, minibatch=cfg.minibatch_size,
                num_blocks=k, iterations=iterations,
                collision=cfg.collision_mode, t0=t0)

        return plain

    def _init_factors_device(
            self, problem: device_blocking.DeviceBlockedProblem):
        """Initial (U, V) f32 tables of a device-blocked problem, on its
        device (the per-id keyed rows)."""
        cfg = self.config
        return device_blocking.init_factors_device(
            problem, cfg.num_factors, scale=cfg.init_scale)

    def _init_factors(self, problem: blocking.BlockedProblem):
        """Initial (U, V) f32 tables: per-id keyed rows on the solver's
        device when ``seed`` is set, else one CPU stream per table."""
        cfg = self.config
        if cfg.seed is not None:
            init_u = PseudoRandomFactorInitializer(cfg.num_factors,
                                                   scale=cfg.init_scale)
            init_v = PseudoRandomFactorInitializer(cfg.num_factors,
                                                   scale=cfg.init_scale)
        else:
            init_u = RandomFactorInitializer(cfg.num_factors, seed=0, salt=0,
                                             scale=cfg.init_scale)
            init_v = RandomFactorInitializer(cfg.num_factors, seed=0, salt=1,
                                             scale=cfg.init_scale)
        dev = self.device if cfg.seed is not None else "cpu"
        U = init_u(torch.as_tensor(problem.users.ids.clip(min=0), device=dev))
        V = init_v(torch.as_tensor(problem.items.ids.clip(min=0), device=dev))
        return U, V

    # -- scoring passthroughs ----------------------------------------------

    def predict(self, user_ids, item_ids, return_mask: bool = False):
        self._require_fitted()
        return self.model.predict(user_ids, item_ids, return_mask=return_mask)

    def empirical_risk(self, data: Ratings) -> float:
        self._require_fitted()
        return self.model.empirical_risk(data, lambda_=self.config.lambda_)

    def _require_fitted(self):
        if self.model is None:
            raise RuntimeError(
                "model has not been fitted; call fit() before predicting"
            )
