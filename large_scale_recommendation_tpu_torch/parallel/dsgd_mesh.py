"""Mesh DSGD: the stratum rotation over a ring of ranks (counterpart of
``large_scale_recommendation_tpu.parallel.dsgd_mesh``).

The reference runs DSGD on k workers, each holding one user block and one
rotating item block (DSGDforMF.scala:611-619). The JAX package runs the
``iterations × k`` sub-step loop inside one ``shard_map``; here every rank
runs it as its own process, on the ``Partitioner``'s data ring:

- U: rank p holds user block p (``('users', 'rank')``);
- V: rank p starts with item block p and, after each sub-step, receives
  the next block from p + 1 (the ring shift, ``batch_isend_irecv``), with
  its ω; after ``iterations × k`` sub-steps every block is home again;
- ratings: rank p holds its device-major cells ``[k, b]``: cell s is
  block (p, (p+s) mod k), the block it sweeps at sub-step s, with
  block-local rows (``device_major_local_strata``).

Sub-step ``idx`` sweeps cell ``s = idx mod k`` at schedule step
``t = idx // k + 1 + t0``, then shifts V. Two routes (``kernel``):

- ``"cuda"`` (the JAX ``"pallas"`` route, the default): the CUDA step pair
  per visit (``ops.cuda_sgd.block_sweep`` over a plan built once per fit;
  bf16 tables cast around each visit, and the ring carries bf16). It
  inlines the λ/ω rule and the collision scales, and holds full rows, so
  rank sharding (``model_parallel > 1``) raises ``NotImplementedError``.
  On CPU tensors it runs the kernel's plain version;
- ``"torch"`` (the JAX ``"xla"`` route): ``ops.sgd.sgd_block_sweep`` with
  any updater and collision mode; with ``model_parallel > 1`` each rank
  holds a column slice and the prediction dot is summed over the model
  group; bf16 tables are upcast once per segment (the ring carries f32)
  and rounded back at its end.

Segments and checkpoints follow ``models.dsgd``: each segment of
``checkpoint_every`` sweeps ends in a ``ShardedCheckpointManager`` save of
every rank's own shards (no gather), and ``resume=True`` continues from
the latest one, re-sharded to the current grid, refusing a snapshot of the
other fit path. ``fit`` and ``fit_device`` block the whole problem on
every rank (deterministic) and keep their slices; the fitted model keeps
its shards on their ranks (``models.mf.ShardedMFModel``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.core.updaters import (
    RegularizedSGDUpdater,
    schedule_from_name,
)
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data import device_blocking
from large_scale_recommendation_tpu_torch.models.dsgd import (
    _FACTOR_DTYPES,
    DSGD,
    DSGDConfig,
)
from large_scale_recommendation_tpu_torch.models.mf import ShardedMFModel
from large_scale_recommendation_tpu_torch.obs.instrument import (
    TrainSegmentTimer,
)
from large_scale_recommendation_tpu_torch.ops import cuda_sgd
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
    as_partitioner,
)
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    ShardedCheckpointManager,
    restore_segment_state_sharded,
)

KERNELS = ("cuda", "torch")


def device_major_local_strata(
    problem: blocking.BlockedProblem,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stratum-major blocks [s, p, b] re-laid device-major [p, s, b] with
    block-local rows: cell [p, s] is rating block (p, (p+s) mod k), and a
    local row is the global row mod rows-per-block (blocks are contiguous
    row ranges)."""
    br = problem.ratings
    u = br.u_rows.transpose(1, 0, 2) % problem.users.rows_per_block
    i = br.i_rows.transpose(1, 0, 2) % problem.items.rows_per_block
    v = br.values.transpose(1, 0, 2)
    w = br.weights.transpose(1, 0, 2)
    return (u.astype(np.int32), i.astype(np.int32),
            v.astype(np.float32), w.astype(np.float32))


def build_mesh_dsgd_step(mesh, updater: Any, minibatch: int,
                         num_blocks: int, collision: str = "mean",
                         with_inv: bool = False, kernel: str = "cuda"):
    """The training function of one rank:

        fn(U_l, V_l, omega_u, omega_v, strata, *, iterations, t0, plan=None)
            -> (U_l, V_l)

    ``U_l``/``V_l`` are the rank's block tables and ``omega_*`` their
    per-row ω; ``strata`` its cells ``(ru, ri, rv, rw, icu, icv)`` as
    ``[k, b]`` tensors (``icu``/``icv`` None without precomputed
    collision scales). ``U_l`` is updated in place; V rotates, so the
    returned ``V_l`` is a new tensor. The ``"cuda"`` route takes ``plan``,
    ``cuda_sgd.build_step_plan`` of the strata as ``[k, 1, b]`` (built
    here when absent). ``t0`` is the sweeps already done (the schedule
    continues across segments)."""
    part = as_partitioner(mesh)
    k = num_blocks
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    if kernel == "cuda":
        # the step pair holds full factor rows: no rank-sliced variant
        part.require_no_model_parallel("mesh DSGD cuda kernel")
        cuda_sgd.validate_cuda_contract(updater, collision, with_inv)
    pred_axis = part.model if part.model_parallel > 1 else None

    def run(U_l, V_l, omega_u, omega_v, strata, *, iterations: int,
            t0: int = 0, plan=None):
        ru, ri, rv, rw, icu, icv = strata
        ov = omega_v
        if kernel == "cuda":
            if plan is None:
                plan = visit_plan(strata, minibatch)
            work = plan.new_work(int(U_l.shape[-1]))
            for idx in range(iterations * k):
                s = idx % k
                lr = cuda_sgd._lr_at(updater.learning_rate, updater.schedule,
                                     idx // k + 1 + int(t0))
                cuda_sgd.block_sweep(U_l, V_l, omega_u, ov, plan, s, work,
                                     lr=lr, lam=float(updater.lambda_))
                V_l, ov = part.ring_shift(V_l, ov)
            cuda_sgd.note_launches(plan, int(U_l.shape[-1]), iterations,
                                   half=U_l.dtype == torch.bfloat16)
            return U_l, V_l
        store = U_l.dtype
        if store == torch.bfloat16:  # one upcast per segment
            U_l, V_l = U_l.float(), V_l.float()
        for idx in range(iterations * k):
            s = idx % k
            sgd_ops.sgd_block_sweep(
                U_l, V_l, ru[s], ri[s], rv[s], rw[s], omega_u, ov, updater,
                idx // k + 1 + int(t0), minibatch, collision,
                None if icu is None else icu[s],
                None if icv is None else icv[s], pred_axis)
            V_l, ov = part.ring_shift(V_l, ov)
        return U_l.to(store), V_l.to(store)

    return run


def visit_plan(strata, minibatch: int) -> cuda_sgd.StepPlan:
    """The step plan of one rank's cells ``[k, b]`` as ``[k, 1, b]``: one
    visit per stratum, block-local rows (``cuda_sgd.block_sweep``)."""
    return cuda_sgd.build_step_plan(*(a[:, None] for a in strata),
                                    minibatch=minibatch)


@dataclasses.dataclass(frozen=True)
class MeshDSGDConfig:
    """``DSGDConfig`` for the mesh; ``num_blocks`` is the data ring's
    size."""

    num_factors: int = 10
    lambda_: float = 1.0
    iterations: int = 10
    learning_rate: float = 0.001
    lr_schedule: str = "inverse_sqrt"
    seed: int | None = 0
    minibatch_size: int = 1024
    init_scale: float = 1.0
    collision_mode: str = "mean"
    precompute_collisions: bool = True
    minibatch_sort: str | None = None
    kernel: str = "cuda"  # "cuda" | "torch" (the module docstring)
    # "float32" | "bfloat16": tables at rest; f32 accumulation in both
    # routes
    factor_dtype: str = "float32"


class MeshDSGD:
    """DSGD over the ranks of a ``Partitioner`` (default: every rank of
    the process group, on the card). Every rank calls ``fit`` /
    ``fit_device`` with the same arguments."""

    def __init__(self, config: MeshDSGDConfig | None = None, mesh=None,
                 updater: Any = None,
                 partitioner: Partitioner | None = None):
        self.config = config or MeshDSGDConfig()
        self.partitioner = (partitioner if partitioner is not None
                            else as_partitioner(mesh))
        self.mesh = self.partitioner
        self.updater = updater or RegularizedSGDUpdater(
            learning_rate=self.config.learning_rate,
            lambda_=self.config.lambda_,
            schedule=schedule_from_name(self.config.lr_schedule,
                                        self.config.lambda_))
        self.model: ShardedMFModel | None = None
        # device ms of each segment of the last fit (CUDA events around
        # the segment's launches and ring shifts); empty on the CPU
        self.segment_ms: list[float] = []

    @property
    def num_blocks(self) -> int:
        return self.partitioner.num_blocks

    @property
    def device(self) -> torch.device:
        return self.partitioner.device

    def _init_factors(self, problem: blocking.BlockedProblem):
        """The whole initial tables of a host-blocked problem: the
        single-device solver's (per-id keyed rows)."""
        cfg = self.config
        return DSGD(DSGDConfig(num_factors=cfg.num_factors, seed=cfg.seed,
                               init_scale=cfg.init_scale),
                    device=self.device)._init_factors(problem)

    def fit(self, ratings: Ratings, checkpoint_manager=None,
            checkpoint_every: int | None = None,
            resume: bool = False) -> ShardedMFModel:
        """Train on host-blocked ratings (the same ratings and seed on
        every rank); the checkpoint contract of ``DSGD.fit``, per rank."""
        cfg = self.config
        if ratings.n == 0:
            raise ValueError("cannot fit on an empty ratings set")
        k = self.num_blocks
        problem = blocking.block_problem(
            ratings, num_blocks=k, seed=cfg.seed,
            minibatch_multiple=cfg.minibatch_size,
            minibatch_sort=cfg.minibatch_sort)
        strata = device_major_local_strata(problem)
        U, V = self._init_factors(problem)
        if cfg.precompute_collisions and cfg.collision_mode == "mean":
            icu, icv = blocking.minibatch_inv_counts(problem.ratings,
                                                     cfg.minibatch_size)
            inv = (icu.transpose(1, 0, 2), icv.transpose(1, 0, 2))
        else:
            inv = (None, None)
        U_l, V_l = self._train_segments(
            U, V, strata + inv, problem.users.omega, problem.items.omega,
            "mesh_dsgd_segment", checkpoint_manager, checkpoint_every,
            resume, n_ratings=int(ratings.n))
        self.model = ShardedMFModel(U=U_l, V=V_l, users=problem.users,
                                    items=problem.items,
                                    partitioner=self.partitioner)
        return self.model

    def fit_device(self, u, i, r, num_users: int, num_items: int,
                   checkpoint_manager=None,
                   checkpoint_every: int | None = None,
                   resume: bool = False) -> ShardedMFModel:
        """Train through the on-device data pipeline: dense ids as host
        arrays or tensors (the same on every rank); blocking, the
        device-major re-layout (two transposes and a mod), collision scales
        and the per-id keyed init run on the rank's device."""
        cfg = self.config
        p = device_blocking.device_block_problem(
            u, i, r, num_users, num_items, num_blocks=self.num_blocks,
            minibatch_multiple=cfg.minibatch_size,
            seed=cfg.seed if cfg.seed is not None else 0,
            minibatch_sort=cfg.minibatch_sort, device=self.device)
        return self._fit_problem(p, checkpoint_manager, checkpoint_every,
                                 resume)

    def _fit_problem(self, p: device_blocking.DeviceBlockedProblem,
                     checkpoint_manager=None,
                     checkpoint_every: int | None = None,
                     resume: bool = False) -> ShardedMFModel:
        """Train on a device-blocked problem (the seam a test uses to train
        on a layout carried across from the JAX package)."""
        cfg = self.config
        strata = (p.su.transpose(0, 1) % p.rows_per_block_u,
                  p.si.transpose(0, 1) % p.rows_per_block_v,
                  p.sv.transpose(0, 1), p.sw.transpose(0, 1))
        if cfg.precompute_collisions and cfg.collision_mode == "mean":
            inv = (p.icu.transpose(0, 1), p.icv.transpose(0, 1))
        else:
            inv = (None, None)
        U, V = self._init_factors_device(p)
        U_l, V_l = self._train_segments(
            U, V, strata + inv, p.omega_u, p.omega_v,
            "mesh_dsgd_device_segment", checkpoint_manager,
            checkpoint_every, resume, n_ratings=int(p.nnz))
        users, items = p.to_id_indices()
        self.model = ShardedMFModel(U=U_l, V=V_l, users=users, items=items,
                                    partitioner=self.partitioner)
        return self.model

    def _init_factors_device(self, p: device_blocking.DeviceBlockedProblem):
        cfg = self.config
        return device_blocking.init_factors_device(p, cfg.num_factors,
                                                   scale=cfg.init_scale)

    def _train_segments(self, U, V, strata, omega_u, omega_v, kind,
                        checkpoint_manager, checkpoint_every, resume, *,
                        n_ratings: int):
        """The segment loop and checkpoint/resume of both paths: the whole
        tables ``U``/``V`` and layouts in, this rank's trained slices out.
        A plain ``CheckpointManager`` is re-targeted at its directory in
        the sharded format. Each segment runs inside a
        ``TrainSegmentTimer("mesh_dsgd", kind)``; ``n_ratings`` (all
        ranks' ratings a sweep visits) is its unit."""
        if isinstance(checkpoint_manager, CheckpointManager):
            checkpoint_manager = ShardedCheckpointManager(
                checkpoint_manager.directory, keep=checkpoint_manager.keep)
        cfg = self.config
        part = self.partitioner
        if cfg.factor_dtype not in _FACTOR_DTYPES:
            raise ValueError(f"factor_dtype {cfg.factor_dtype!r} "
                             "unsupported; float32 or bfloat16")
        fdt = _FACTOR_DTYPES[cfg.factor_dtype]
        with_inv = strata[4] is not None
        step = build_mesh_dsgd_step(part, self.updater, cfg.minibatch_size,
                                    self.num_blocks, cfg.collision_mode,
                                    with_inv, cfg.kernel)
        U = torch.as_tensor(U).to(fdt)
        V = torch.as_tensor(V).to(fdt)
        part.require_rank_divisible(int(U.shape[-1]), "mesh DSGD")
        done = 0
        if resume:
            if checkpoint_manager is None:
                raise ValueError("resume=True requires a checkpoint_manager")
            U_l, V_l, done = restore_segment_state_sharded(
                checkpoint_manager, kind, U, V, part)
        else:
            U_l = part.place(U, "users", "rank")
            V_l = part.place(V, "items", "rank")
        del U, V
        local = tuple(None if a is None else part.place(a, "ratings")[0]
                      for a in strata)
        ou = part.place(omega_u, "users").float()
        ov = part.place(omega_v, "items").float()
        plan = (visit_plan(local, cfg.minibatch_size)
                if cfg.kernel == "cuda" else None)
        timed = self.device.type == "cuda"
        events = []
        segment = checkpoint_every or cfg.iterations
        timer = TrainSegmentTimer(
            "mesh_dsgd", kind, shape_key=(tuple(U_l.shape), tuple(V_l.shape),
                                          tuple(local[0].shape)))
        while done < cfg.iterations:
            seg = min(segment, cfg.iterations - done)
            with timer.segment(seg) as h:
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                U_l, V_l = step(U_l, V_l, ou, ov, local, iterations=seg,
                                t0=done, plan=plan)
                if timed:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    events.append((start, end))
                h.out = (U_l, V_l)
            done += seg
            if checkpoint_manager is not None:
                checkpoint_manager.save(
                    done, {"U": part.local_shard(U_l, "users", "rank"),
                           "V": part.local_shard(V_l, "items", "rank")},
                    {"kind": kind, "iterations": cfg.iterations})
        if events:
            events[-1][1].synchronize()
        self.segment_ms = [a.elapsed_time(b) for a, b in events]
        m = part.model_parallel
        rank = int(U_l.shape[-1]) * m  # U_l holds a 1/m column slice
        if plan is not None:  # the step pair: this rank's visits
            model_bytes = sgd_ops.dsgd_bytes_per_sweep(
                plan.entry_base[-1], rank, kernel="cuda",
                user_rows=sum(plan.u_segments),
                item_rows=sum(plan.v_segments))
        else:
            model_bytes = sgd_ops.dsgd_bytes_per_sweep(
                n_ratings, rank, factor_bytes=fdt.itemsize, model_size=m)
        timer.finish(
            n_ratings, bytes_per_iteration=model_bytes,
            flops_per_iteration=sgd_ops.dsgd_flops_per_sweep(n_ratings,
                                                             rank),
            collective_bytes_per_iteration=(
                sgd_ops.dsgd_collective_bytes_per_sweep(n_ratings, rank, m)))
        return U_l, V_l
