"""ALS: alternating least squares matrix factorization, the batch solver
beside DSGD (counterpart of ``large_scale_recommendation_tpu.models.als``).

Two data paths feed the same rounds (``ops.als.als_rounds``):

- ``fit``: external ids, compacted to rows by ``data.blocking`` (one
  block) and planned on the host (``build_solve_plan``); the chunked
  buckets then live on the solver's device for the whole fit;
- ``fit_device``: dense ids, planned on the solver's device
  (``device_prepare_side``); only the 32-entry class counts come back.

Each round is a user half-step then an item half-step: bucketed gathers,
batched grams and batched Cholesky solves, in torch ops on the device (the
JAX package leaves them to XLA; there is no Pallas kernel on this path).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
    RandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data.device_blocking import (
    validate_dense_ids,
)
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.obs.instrument import (
    TrainSegmentTimer,
)
from large_scale_recommendation_tpu_torch.obs.trace import span
from large_scale_recommendation_tpu_torch.ops import als as als_ops
from large_scale_recommendation_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    num_factors: int = 10
    lambda_: float = 0.1
    iterations: int = 10
    reg_mode: str = "direct"  # "direct" (plain λ·I) | "als_wr" (ω-scaled)
    seed: int | None = 0
    min_pad: int = 8  # smallest per-row bucket width (ops.als plans)
    init_scale: float = 0.1
    # iALS: ratings are interaction strengths with confidence 1 + α·r
    implicit_alpha: float | None = None
    # "bf16" gathers the fixed side in bf16; contractions and the solve
    # stay f32 (ops.als). None = f32 throughout.
    gram_dtype: str | None = None


class ALS:
    """Batch ALS solver with the surface of ``DSGD``. ``device=None`` runs
    on the card."""

    def __init__(self, config: ALSConfig | None = None, device=None):
        self.config = config or ALSConfig()
        self.device = resolve_device(device)
        self.model: MFModel | None = None
        # fit-boundary hook ``on_segment(U, V, label=, step=)``; None = one
        # pointer test per fit
        self.evaluator = None
        # device ms of each round of the last fit (CUDA events around the
        # round's work); empty on the CPU
        self.round_ms: list[float] = []
        # seconds to build the last fit's two plans: ``fit``'s host plans
        # (the buckets go to the device inside the rounds' call), or
        # ``fit_device``'s device plans (on the card CUDA events, read
        # after the rounds' last wait)
        self.plan_s: float | None = None

    def fit(self, ratings: Ratings) -> MFModel:
        cfg = self.config
        gram_dtype = self._gram_dtype()  # validate before the plan build
        if ratings.n == 0:
            raise ValueError("cannot fit on an empty ratings set")

        ru, ri, rv, rw = ratings.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]

        users = blocking.build_id_index(ru, num_blocks=1, seed=cfg.seed)
        items = blocking.build_id_index(
            ri, num_blocks=1, seed=None if cfg.seed is None else cfg.seed + 1
        )
        u_rows, _ = users.rows_for(ru)
        i_rows, _ = items.rows_for(ri)

        start = time.perf_counter()
        user_plan = als_ops.build_solve_plan(
            u_rows, i_rows, rv, users.num_rows, min_pad=cfg.min_pad)
        item_plan = als_ops.build_solve_plan(
            i_rows, u_rows, rv, items.num_rows, min_pad=cfg.min_pad)
        self.plan_s = time.perf_counter() - start

        U, V = self._init_factors(users, items)
        self.round_ms = []
        timer = TrainSegmentTimer("als", "als_planned",
                                  shape_key=(tuple(U.shape), tuple(V.shape)))
        with timer.segment(cfg.iterations) as h:
            U, V = als_ops.als_train_planned(
                U, V, user_plan, item_plan, users.omega, items.omega,
                lambda_=cfg.lambda_, iterations=cfg.iterations,
                reg_mode=cfg.reg_mode, implicit_alpha=cfg.implicit_alpha,
                gram_dtype=gram_dtype, round_ms=self.round_ms)
            h.out = (U, V)
        timer.finish(int(len(ru)))
        if self.evaluator is not None:
            self.evaluator.on_segment(U, V, label="als_planned",
                                      step=cfg.iterations)
        self.model = MFModel(U=U, V=V, users=users, items=items)
        return self.model

    def fit_device(self, u, i, r, num_users: int, num_items: int) -> MFModel:
        """Fit through device-built solve plans
        (``ops.als.device_prepare_side``): dense ids in ``[0, num_users) ×
        [0, num_items)`` as host arrays or tensors; plans, init and rounds
        on the solver's device. Ids unseen in training stay unknown
        (predict 0), as on the host path."""
        cfg = self.config
        gram_dtype = self._gram_dtype()  # validate before the plan build
        if len(u) == 0:
            raise ValueError("cannot fit on an empty ratings set")
        validate_dense_ids(u, i, num_users, num_items, "ALS.fit_device")
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(a, device=dev).to(dtype)

        u, i, r = put(u, torch.int32), put(i, torch.int32), put(r, torch.float32)
        on_card = dev.type == "cuda"
        if on_card:
            plan_start = torch.cuda.Event(enable_timing=True)
            plan_end = torch.cuda.Event(enable_timing=True)
            plan_start.record()
        else:
            start = time.perf_counter()
        wr = cfg.reg_mode == "als_wr"
        k = cfg.num_factors
        with span("als/plan", device=on_card):
            omega_u = torch.bincount(u.long(), minlength=num_users)
            omega_v = torch.bincount(i.long(), minlength=num_items)
            prep_u = als_ops.device_prepare_side(
                u, i, r, num_users, omega=omega_u.float() if wr else None,
                min_pad=cfg.min_pad, rank_for_chunking=k)
            prep_v = als_ops.device_prepare_side(
                i, u, r, num_items, omega=omega_v.float() if wr else None,
                min_pad=cfg.min_pad, rank_for_chunking=k)
            if cfg.implicit_alpha is not None:
                prep_u = als_ops.implicit_prepared(prep_u, cfg.implicit_alpha)
                prep_v = als_ops.implicit_prepared(prep_v, cfg.implicit_alpha)
        if on_card:
            plan_end.record()
        else:
            self.plan_s = time.perf_counter() - start

        V = self._init_factors_device(num_items, omega_v)
        self.round_ms = []
        timer = TrainSegmentTimer("als", "als_device_rounds",
                                  shape_key=((num_users, k), tuple(V.shape)))
        with timer.segment(cfg.iterations) as h:
            U, V = als_ops.als_rounds(
                V, prep_u, prep_v, num_users, num_items, cfg.lambda_,
                cfg.iterations, implicit=cfg.implicit_alpha is not None,
                gram_dtype=gram_dtype, round_ms=self.round_ms)
            h.out = (U, V)
        if on_card:
            plan_end.synchronize()  # reached by the rounds' last wait
            self.plan_s = plan_start.elapsed_time(plan_end) / 1e3
        timer.finish(int(len(u)))
        if self.evaluator is not None:
            self.evaluator.on_segment(U, V, label="als_device_rounds",
                                      step=cfg.iterations)

        # dense-vocab IdIndex pair with host-path semantics (ids unseen in
        # training stay unknown → predict 0, dropped from risk)
        def index(omega, n_ids):
            om = omega.cpu().numpy().astype(np.float32)
            all_ids = np.arange(n_ids, dtype=np.int64)
            present = om > 0
            return blocking.IdIndex(
                ids=np.where(present, all_ids, -1), num_blocks=1,
                rows_per_block=n_ids, omega=om,
                sorted_ids=all_ids[present], sorted_rows=all_ids[present],
            )

        self.model = MFModel(U=U, V=V, users=index(omega_u, num_users),
                             items=index(omega_v, num_items))
        return self.model

    def _gram_dtype(self):
        d = self.config.gram_dtype
        if d is None:
            return None
        if d in ("bf16", "bfloat16"):
            return torch.bfloat16
        raise ValueError(f"gram_dtype must be None|'bf16', got {d!r}")

    def _init_factors(self, users: blocking.IdIndex, items: blocking.IdIndex):
        """Initial (U, V) f32 tables on the solver's device: per-id keyed
        rows when ``seed`` is set, else one CPU stream per table. Only V's
        init matters (the first half-step solves U from V). Padding rows
        (id −1) start at exactly zero: the implicit VᵀV sums the whole
        table."""
        cfg = self.config
        dev = self.device
        if cfg.seed is not None:
            init = PseudoRandomFactorInitializer(cfg.num_factors,
                                                 scale=cfg.init_scale)
            U = init(torch.as_tensor(users.ids.clip(min=0), device=dev))
            V = init(torch.as_tensor(items.ids.clip(min=0), device=dev))
        else:
            U = RandomFactorInitializer(cfg.num_factors, seed=0, salt=0,
                                        scale=cfg.init_scale)(
                np.arange(users.num_rows)).to(dev)
            V = RandomFactorInitializer(cfg.num_factors, seed=0, salt=1,
                                        scale=cfg.init_scale)(
                np.arange(items.num_rows)).to(dev)
        U = U * torch.as_tensor(users.ids >= 0, device=dev)[:, None]
        V = V * torch.as_tensor(items.ids >= 0, device=dev)[:, None]
        return U, V

    def _init_factors_device(self, num_items: int, omega_v: torch.Tensor):
        """``fit_device``'s initial V on the solver's device: per-id keyed
        rows, zero for ids unseen in training (the host path's zeroed
        padding rows)."""
        cfg = self.config
        init = PseudoRandomFactorInitializer(cfg.num_factors,
                                             scale=cfg.init_scale)
        V = init(torch.arange(num_items, dtype=torch.int64,
                              device=self.device))
        return V * (omega_v > 0)[:, None]

    # -- scoring passthroughs (same surface as DSGD) -----------------------

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
