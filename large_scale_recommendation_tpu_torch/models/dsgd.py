"""DSGD: Gemulla-style stratified SGD matrix factorization (counterpart of
``large_scale_recommendation_tpu.models.dsgd``).

Blocking is a one-time host pass (``data.blocking``); the tables and the
blocked ratings then live on the solver's device for the whole run.

Routing follows the device, not a config field (the port's ``DSGDConfig``
has no ``kernel``):

- on a CUDA device ``fit`` always runs the hand-written stratum-sweep
  kernels (``ops.cuda_sgd.dsgd_train_cuda``). They inline the λ/ω
  ``RegularizedSGDUpdater`` rule and the precomputed collision scales, so
  any other updater, ``collision_mode`` or ``precompute_collisions=False``
  raises ``ValueError``;
- on the CPU ``fit`` runs the plain PyTorch route (``ops.sgd.dsgd_train``)
  with the full ``collision_mode`` semantics.
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
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.ops import cuda_sgd
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, only an explicit CPU request
    is honoured: there is no silent CPU route."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch route on the CPU")
    return dev


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

    def schedule_fn(self):
        return schedule_from_name(self.lr_schedule, self.lambda_)


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
        # segment-boundary hooks, as in the JAX package; not ported yet, so
        # they stay None (one pointer test per segment)
        self.watchdog = None
        self.evaluator = None
        # device ms of each training segment of the last fit (CUDA events
        # around the segment's launches; hooks excluded); empty on the CPU
        self.segment_ms: list[float] = []

    # -- fit ---------------------------------------------------------------

    def fit(self, ratings: Ratings, num_blocks: int | None = None,
            checkpoint_every: int | None = None) -> MFModel:
        """Train. ``checkpoint_every`` runs the sweeps in segments of that
        many iterations (the schedule continues across segments)."""
        cfg = self.config
        if ratings.n == 0:
            raise ValueError("cannot fit on an empty ratings set")
        k = num_blocks or cfg.num_blocks or 1
        use_inv = cfg.precompute_collisions and cfg.collision_mode == "mean"
        if self.device.type == "cuda":
            cuda_sgd.validate_cuda_contract(self.updater, cfg.collision_mode,
                                            use_inv)
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
                                    checkpoint_every)
        self.model = MFModel(U=U, V=V, users=problem.users,
                             items=problem.items)
        return self.model

    def _train_segments(self, U, V, args, k, checkpoint_every=None):
        """The segment loop: ``checkpoint_every`` sweeps per segment, with
        the hooks run at each boundary."""
        cfg = self.config
        segment = checkpoint_every or cfg.iterations
        train = self._train_fn(args, k, int(U.shape[-1]))
        timed = self.device.type == "cuda"
        events = []
        done = 0
        while done < cfg.iterations:
            seg = min(segment, cfg.iterations - done)
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            U, V = train(U, V, iterations=seg, t0=done)
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                events.append((start, end))
            done += seg
            if self.watchdog is not None:
                self.watchdog.after_segment(U, V, label="dsgd_segment")
            if self.evaluator is not None:
                self.evaluator.on_segment(U, V, label="dsgd_segment",
                                          step=done)
        if events:
            events[-1][1].synchronize()
        self.segment_ms = [a.elapsed_time(b) for a, b in events]
        return U, V

    def _train_fn(self, args, k: int, rank: int):
        """Route by device: the CUDA kernels on a card (``fit`` has checked
        their contract), the plain route on the CPU."""
        cfg = self.config
        upd = self.updater
        if self.device.type == "cuda":
            scratch = cuda_sgd.alloc_scratch(k, cfg.minibatch_size, rank,
                                             self.device)

            def cuda(U, V, *, iterations, t0):
                return cuda_sgd.dsgd_train_cuda(
                    U, V, *args, lr=float(upd.learning_rate),
                    lam=float(upd.lambda_), minibatch=cfg.minibatch_size,
                    num_blocks=k, iterations=iterations,
                    schedule=upd.schedule, t0=t0, scratch=scratch)

            return cuda

        def plain(U, V, *, iterations, t0):
            return sgd_ops.dsgd_train(
                U, V, *args, updater=upd, minibatch=cfg.minibatch_size,
                num_blocks=k, iterations=iterations,
                collision=cfg.collision_mode, t0=t0)

        return plain

    def _init_factors(self, problem: blocking.BlockedProblem):
        """Initial (U, V) as CPU float32 tensors: per-id keyed draws when
        ``seed`` is set, else one stream per table."""
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
        U = init_u(problem.users.ids.clip(min=0))
        V = init_v(problem.items.ids.clip(min=0))
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
