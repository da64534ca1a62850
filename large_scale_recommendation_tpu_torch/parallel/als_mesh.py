"""Mesh ALS: block-sharded tables, gathered half-steps (counterpart of
``large_scale_recommendation_tpu.parallel.als_mesh``).

U and V are block-sharded over the data ring as in mesh DSGD. Each
half-step, on every rank:

    V_full = gather(V)            the fixed side, whole (a rank-sharded
                                  rank gathers its model group's columns
                                  first, then the ring's rows)
    A, b   = bucketed grams over the rank's OWN ratings (pre-partitioned
             by the solved side's block, so its rows are rank-local)
    U_l    = batched Cholesky solve of the rank's rows (its columns, when
             rank-sharded: the solve needs the full-rank gram)

then the same for V. Implicit feedback adds the fixed side's whole VᵀV; on
a rank-sharded grid each member of a model group grams a row chunk of the
gathered table and the chunks are summed over the group (zero rows pad it
to a multiple of the group's size and add nothing). With ``gram_dtype``
bf16 the explicit path casts its shard before the gathers (they move half
the bytes); the implicit path gathers f32 and casts inside the solve.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.models.mf import ShardedMFModel
from large_scale_recommendation_tpu_torch.ops import als as als_ops
from large_scale_recommendation_tpu_torch.parallel import collectives
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
    as_partitioner,
)


def build_mesh_als_step(mesh, lambda_: float, reg_mode: str,
                        iterations: int, n_user_buckets: int,
                        n_item_buckets: int, implicit: bool = False,
                        gram_dtype=None):
    """The ALS round loop of one rank:

        fn(U_l, V_l, omega_u, omega_v, *bucket_arrays) -> (U_l, V_l)

    on its block tables, their ω, and its part of ``n_user_buckets`` × 4
    user-side then ``n_item_buckets`` × 4 item-side plan arrays
    (``ops.als.build_sharded_plans``, placed as ``'ratings'``, leading
    dimension dropped). Per round: the two gathers and the bucketed
    gram/solve of each side."""
    part = as_partitioner(mesh)
    model = part.model
    m = part.model_parallel
    pre_cast = gram_dtype is not None and not implicit
    local_dtype = None if pre_cast else gram_dtype

    def full_gram(F):
        if m == 1:
            return als_ops._full_gram(F)
        n = F.shape[0]
        chunk = -(-n // m)
        lo = min(model.index * chunk, n)
        return collectives.group_sum(
            model, als_ops._full_gram(F[lo:min(lo + chunk, n)]))

    def gather_full(F_l):
        if pre_cast:
            F_l = F_l.to(gram_dtype)
        return part.gather(F_l, "items", "rank")

    def keep_rank_slice(F):
        return F if m == 1 else part.rank_slice(F).contiguous()

    def run(U_l, V_l, omega_u, omega_v, *bucket_arrays):
        flat = list(bucket_arrays)
        ub = [tuple(flat[4 * j:4 * j + 4]) for j in range(n_user_buckets)]
        ib = [tuple(flat[4 * (n_user_buckets + j):
                         4 * (n_user_buckets + j) + 4])
              for j in range(n_item_buckets)]
        nu_l, ni_l = U_l.shape[0], V_l.shape[0]
        scale_u = omega_u if reg_mode == "als_wr" else None
        scale_v = omega_v if reg_mode == "als_wr" else None
        for _ in range(iterations):
            V_full = gather_full(V_l)
            Gv = full_gram(V_full) if implicit else None
            U_l = keep_rank_slice(als_ops.solve_side_local(
                V_full, ub, nu_l, lambda_, scale_u, Gv, dtype=local_dtype))
            U_full = gather_full(U_l)
            Gu = full_gram(U_full) if implicit else None
            V_l = keep_rank_slice(als_ops.solve_side_local(
                U_full, ib, ni_l, lambda_, scale_v, Gu, dtype=local_dtype))
        return U_l, V_l

    return run


class MeshALS:
    """ALS over the ranks of a ``Partitioner``, with ``MeshDSGD``'s
    surface. Every rank calls ``fit`` with the same ratings."""

    def __init__(self, config: ALSConfig | None = None, mesh=None,
                 partitioner: Partitioner | None = None):
        self.config = config or ALSConfig()
        self.partitioner = (partitioner if partitioner is not None
                            else as_partitioner(mesh))
        self.mesh = self.partitioner
        self.model: ShardedMFModel | None = None

    @property
    def num_blocks(self) -> int:
        return self.partitioner.num_blocks

    def _init_factors(self, users, items):
        """The whole initial tables: the single-device solver's."""
        return ALS(self.config, device=self.partitioner.device)._init_factors(
            users, items)

    def fit(self, ratings: Ratings) -> ShardedMFModel:
        cfg = self.config
        part = self.partitioner
        gram_dtype = ALS(cfg, device="cpu")._gram_dtype()  # validate first
        if ratings.n == 0:
            raise ValueError("cannot fit on an empty ratings set")
        k = self.num_blocks
        part.require_rank_divisible(cfg.num_factors, "mesh ALS")
        ru, ri, rv, rw = ratings.to_numpy()
        real = rw > 0
        ru, ri, rv = ru[real], ri[real], rv[real]
        if part.world_size > 1 and cfg.seed is None:
            raise ValueError(
                "MeshALS across processes requires a fixed config seed — "
                "the host blocking must be identical on every process")
        users = blocking.build_id_index(ru, num_blocks=k, seed=cfg.seed)
        items = blocking.build_id_index(
            ri, num_blocks=k, seed=None if cfg.seed is None else cfg.seed + 1)
        if part.world_size > 1:
            # every rank must block the same (u, i, r) stream
            digest = torch.tensor([zlib.crc32(
                users.ids.tobytes() + items.ids.tobytes()
                + np.asarray(ru, np.int64).tobytes()
                + np.asarray(ri, np.int64).tobytes()
                + np.asarray(rv, np.float32).tobytes())], dtype=torch.int64,
                device=part.device)
            all_d = collectives.gather(part.world, digest).cpu().numpy()
            if not (all_d == all_d[0]).all():
                raise ValueError(
                    "host blocking diverged across processes (digests "
                    f"{all_d.tolist()}) — every process must pass the "
                    "IDENTICAL full ratings set to MeshALS.fit")
        u_rows, _ = users.rows_for(ru)
        i_rows, _ = items.rows_for(ri)
        rv = np.asarray(rv, np.float32)
        # the single-device chunk geometry (256 MB, ``ALS.fit``'s; the JAX
        # mesh cuts 64 MB chunks): a rank batches its grams and Cholesky
        # solves as ``ALS.fit`` does, and at world size 1 it is that fit
        plan_kw = dict(min_pad=cfg.min_pad, target_bytes=256 << 20,
                       implicit_alpha=cfg.implicit_alpha)
        user_plan = als_ops.build_sharded_plans(
            u_rows % users.rows_per_block, u_rows // users.rows_per_block,
            i_rows, rv, k, users.rows_per_block, cfg.num_factors, **plan_kw)
        item_plan = als_ops.build_sharded_plans(
            i_rows % items.rows_per_block, i_rows // items.rows_per_block,
            u_rows, rv, k, items.rows_per_block, cfg.num_factors, **plan_kw)
        U, V = self._init_factors(users, items)
        step = build_mesh_als_step(
            part, cfg.lambda_, cfg.reg_mode, cfg.iterations, len(user_plan),
            len(item_plan), implicit=cfg.implicit_alpha is not None,
            gram_dtype=gram_dtype)
        U_l, V_l = step(
            part.place(U, "users", "rank").float(),
            part.place(V, "items", "rank").float(),
            part.place(users.omega, "users").float(),
            part.place(items.omega, "items").float(),
            *(part.place(a, "ratings")[0] for b in user_plan for a in b),
            *(part.place(a, "ratings")[0] for b in item_plan for a in b))
        self.model = ShardedMFModel(U=U_l, V=V_l, users=users, items=items,
                                    partitioner=part)
        return self.model
