"""The matrix-factorization model object: factors, scoring, risk, top-K
serving and ranking quality (counterpart of
``large_scale_recommendation_tpu.models.mf``).

Factors live as dense float32 or bfloat16 tables on the model's device;
pair scoring and the factor exports compute in float32, full-catalog
ranking as ``ops.topk`` says. External ids map to rows through the
host-side ``IdIndex`` lookup tables.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.types import FactorVector, Ratings
from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.ops import topk
from large_scale_recommendation_tpu_torch.parallel import serving as psrv
from large_scale_recommendation_tpu_torch.utils import metrics


def masked_scores(scores, u_mask, i_mask, return_mask: bool):
    """Pairs whose user or item was never seen score 0.0; ``return_mask``
    additionally returns the bool ``seen`` mask."""
    seen = (np.asarray(u_mask) * np.asarray(i_mask)) > 0
    out = np.asarray(scores) * seen
    return (out, seen) if return_mask else out


def _top_ids(queries: IdIndex, Q, catalog: IdIndex, C, query_ids, *,
             k: int, train, chunk: int, return_mask: bool):
    """Top-K of ``C``'s rows per known query id by
    ``ops.topk.recommend_rows`` in id space (the id map on the device, as
    the serving engine maps); ``train``: (query, catalog) exclusion rows."""
    rows, mask = queries.rows_for(np.asarray(query_ids))
    ids_of_row = np.asarray(catalog.ids, np.int64)
    ids, scores = topk.recommend_rows(
        Q, C, rows[mask > 0], k=k, train_u=train[0], train_i=train[1],
        chunk=chunk, item_mask=ids_of_row >= 0,
        ids_of_row=topk.to_device(ids_of_row, Q.device))
    out = topk.fill_unknown(mask > 0, ids, scores)
    return (*out, mask > 0) if return_mask else out


def _mesh_top_ids(users: IdIndex, items: IdIndex, U, catalog, user_ids, *,
                  k: int, train, chunk: int, return_mask: bool):
    """``mesh_top_k_recommend`` of the known users, its rows in item ids
    by ``ops.topk.ids_of_top``."""
    rows, mask = users.rows_for(np.asarray(user_ids))
    top_rows, top_scores = psrv.mesh_top_k_recommend(
        U, None, rows[mask > 0], k=k, train_u=train[0], train_i=train[1],
        chunk=chunk, catalog=catalog)
    ids_of_row = torch.from_numpy(np.asarray(items.ids, np.int64))
    scores, ids = topk.ids_of_top(
        torch.from_numpy(top_scores), torch.from_numpy(top_rows).long(),
        ids_of_row, len(ids_of_row))
    out = topk.fill_unknown(mask > 0, ids.numpy(), scores.numpy())
    return (*out, mask > 0) if return_mask else out


@dataclasses.dataclass
class MFModel:
    """A trained factorization: U, V on one device + the id maps."""

    U: torch.Tensor  # float32|bfloat16[num_user_rows, rank]
    V: torch.Tensor  # float32|bfloat16[num_item_rows, rank]
    users: IdIndex
    items: IdIndex

    @property
    def device(self) -> torch.device:
        return self.U.device

    @property
    def rank(self) -> int:
        return int(self.U.shape[-1])

    def _rows(self, *arrays):
        return [torch.as_tensor(np.asarray(a), device=self.device)
                for a in arrays]

    def predict(self, user_ids: np.ndarray, item_ids: np.ndarray,
                return_mask: bool = False):
        """Score (user, item) pairs; pairs whose user or item was never seen
        score 0.0. ``return_mask=True`` returns ``(scores, seen)``."""
        u_rows, u_mask = self.users.rows_for(np.asarray(user_ids))
        i_rows, i_mask = self.items.rows_for(np.asarray(item_ids))
        ur, ir = self._rows(u_rows, i_rows)
        scores = sgd_ops.predict_rows(self.U, self.V, ur, ir).cpu().numpy()
        return masked_scores(scores, u_mask, i_mask, return_mask)

    def _labeled(self, data: Ratings):
        ru, ri, rv, rw = data.to_numpy()
        u_rows, u_mask = self.users.rows_for(ru)
        i_rows, i_mask = self.items.rows_for(ri)
        mask = (u_mask * i_mask * rw).astype(np.float32)
        return u_rows, i_rows, rv, mask

    def empirical_risk(self, data: Ratings, lambda_: float = 1.0) -> float:
        """Σ residual² + λ(‖u‖²+‖v‖²) over labeled points; unseen pairs are
        dropped."""
        u_rows, i_rows, rv, mask = self._labeled(data)
        return float(sgd_ops.empirical_risk_rows(
            self.U, self.V, *self._rows(u_rows, i_rows, rv, mask),
            float(np.float32(lambda_))))

    def rmse(self, data: Ratings) -> float:
        """Root-mean-square error over labeled points."""
        u_rows, i_rows, rv, mask = self._labeled(data)
        n = mask.sum()
        if n == 0:
            return float("nan")
        sse = sgd_ops.sse_rows(self.U, self.V,
                               *self._rows(u_rows, i_rows, rv, mask))
        return float(np.sqrt(float(sse) / n))

    def ranking_quality(self, eval_u, eval_i, k: int = 10,
                        train: "Ratings | tuple | None" = None,
                        chunk: int = 2048) -> dict:
        """HR@K / NDCG@K of held-out (user, item) positives by full-catalog
        ranking (``metrics.ranking_metrics``). Pairs whose user or item was
        never seen are dropped; ``train`` (a ``Ratings`` or a
        ``(user_ids, item_ids)`` pair) excludes already-interacted items
        from each user's ranked list."""
        u_rows, u_mask = self.users.rows_for(np.asarray(eval_u))
        i_rows, i_mask = self.items.rows_for(np.asarray(eval_i))
        keep = (u_mask * i_mask) > 0
        tu, ti = self._train_rows(train)
        # block-padded tables hold init rows with no item behind them;
        # masked out of the catalog, or they rank as phantoms
        return metrics.ranking_metrics(
            self.U, self.V, u_rows[keep], i_rows[keep], k=k, train_u=tu,
            train_i=ti, chunk=chunk, item_mask=self.items.ids >= 0)

    def recommend_users(self, item_ids, k: int = 10,
                        train: "Ratings | tuple | None" = None,
                        chunk: int = 2048, return_mask: bool = False):
        """Top-K users per item: ``recommend`` with the roles of U and V
        swapped (``train`` pairs are still (user, item)). Returns
        ``(user_ids int64 [n, k], scores)`` with the same unknown-id and
        below-catalog conventions."""
        tu, ti = self._train_rows(train)
        return _top_ids(self.items, self.V, self.users, self.U, item_ids,
                        k=k, train=(ti, tu),  # exclusion pairs swap too
                        chunk=chunk, return_mask=return_mask)

    def _train_rows(self, train: "Ratings | tuple | None"):
        """A ``Ratings`` / ``(user_ids, item_ids)`` exclusion set in row
        space, never-seen pairs dropped: the one copy of the exclusion
        contract that evaluation and serving share."""
        if train is None:
            return None, None
        if isinstance(train, tuple):
            tru, tri = train
        else:
            tru, tri, _, _ = train.to_numpy()
        tr_u, tr_um = self.users.rows_for(np.asarray(tru))
        tr_i, tr_im = self.items.rows_for(np.asarray(tri))
        tkeep = (tr_um * tr_im) > 0
        return tr_u[tkeep], tr_i[tkeep]

    def recommend(self, user_ids, k: int = 10,
                  train: "Ratings | tuple | None" = None,
                  chunk: int = 2048, return_mask: bool = False,
                  mesh=None):
        """Top-K items per user by full-catalog score, on the scoring
        protocol of ``ranking_quality`` (``ops.topk``, as the serving
        engine scores), so HR@K/NDCG@K evaluate the list served here.

        ``train`` (a ``Ratings`` or ``(user_ids, item_ids)`` pair) excludes
        each user's already-interacted items. Returns ``(item_ids int64
        [n, k], scores float32 [n, k])`` sorted by descending score. Users
        never seen in training get ids -1 and scores 0.0 (the ``predict``
        convention); slots beyond the effective catalog carry -1/0.0 too.
        ``return_mask=True`` appends the per-user seen mask.

        ``mesh`` (a ``parallel.partitioner.Partitioner``) serves over an
        item-sharded catalog: each rank scores its rows of V (its columns
        too, rank-sharded) and keeps a local top-k, then the candidates are
        gathered and merged (``parallel.serving.mesh_top_k_recommend``).
        Every rank calls it with the same arguments, and every rank gets
        the lists. The sharded catalog is built once per partitioner and
        rebuilt when ``V`` changes (its ``catalog_version``)."""
        tu, ti = self._train_rows(train)
        if mesh is None:
            return _top_ids(self.users, self.U, self.items, self.V, user_ids,
                            k=k, train=(tu, ti), chunk=chunk,
                            return_mask=return_mask)
        cache = self.__dict__.setdefault("_serving_catalogs", {})
        cat = cache.get(mesh)
        if cat is None or cat.version != psrv.catalog_version(self.V):
            cat = cache[mesh] = psrv.shard_catalog(
                self.V, mesh, item_mask=np.asarray(self.items.ids) >= 0)
        return _mesh_top_ids(self.users, self.items, self.U, cat, user_ids,
                             k=k, train=(tu, ti), chunk=chunk,
                             return_mask=return_mask)

    def user_factors(self) -> Iterator[FactorVector]:
        """(id, float32 factors) for every real user row."""
        U = self.U.float().cpu().numpy()
        for row, ident in enumerate(self.users.ids):
            if ident >= 0:
                yield FactorVector(int(ident), U[row])

    def item_factors(self) -> Iterator[FactorVector]:
        V = self.V.float().cpu().numpy()
        for row, ident in enumerate(self.items.ids):
            if ident >= 0:
                yield FactorVector(int(ident), V[row])


@dataclasses.dataclass
class ShardedMFModel:
    """A factorization trained on the mesh (``MeshDSGD``, ``MeshALS``):
    this rank's shards of U and V (``Partitioner.place`` of
    ``('users', 'rank')`` and ``('items', 'rank')``) and the id maps. The
    shards stay on their ranks; every method is collective (each rank
    calls it with the same arguments).

    ``recommend`` serves over the mesh from the rank's own V shard and
    gathers U explicitly (the query side). ``gather`` assembles the whole
    tables on every rank, and the other scoring methods (``predict``,
    ``rmse``, ``empirical_risk``, ``ranking_quality``, ``recommend_users``)
    run on that gathered ``MFModel``, as the JAX package reads whole
    tables there."""

    U: torch.Tensor
    V: torch.Tensor
    users: IdIndex
    items: IdIndex
    partitioner: object

    @property
    def device(self) -> torch.device:
        return self.U.device

    @property
    def rank(self) -> int:
        return int(self.U.shape[-1]) * self.partitioner.model_parallel

    def gather(self) -> MFModel:
        """The whole tables on every rank (a collective)."""
        part = self.partitioner
        return MFModel(U=part.gather(self.U, "users", "rank"),
                       V=part.gather(self.V, "items", "rank"),
                       users=self.users, items=self.items)

    def predict(self, user_ids, item_ids, return_mask: bool = False):
        return self.gather().predict(user_ids, item_ids,
                                     return_mask=return_mask)

    def rmse(self, data: Ratings) -> float:
        return self.gather().rmse(data)

    def empirical_risk(self, data: Ratings, lambda_: float = 1.0) -> float:
        return self.gather().empirical_risk(data, lambda_)

    def ranking_quality(self, eval_u, eval_i, k: int = 10, train=None,
                        chunk: int = 2048) -> dict:
        return self.gather().ranking_quality(eval_u, eval_i, k=k,
                                             train=train, chunk=chunk)

    def recommend_users(self, item_ids, k: int = 10, train=None,
                        chunk: int = 2048, return_mask: bool = False):
        return self.gather().recommend_users(item_ids, k=k, train=train,
                                             chunk=chunk,
                                             return_mask=return_mask)

    def recommend(self, user_ids, k: int = 10, train=None,
                  chunk: int = 2048, return_mask: bool = False):
        """``MFModel.recommend(mesh=)`` on the shards: the catalog is this
        rank's V shard as it lies, and U is gathered (every rank needs the
        queries' full rows). Both are built on the first call and kept
        until a shard changes (its ``catalog_version``), as
        ``MFModel.recommend(mesh=)`` keeps its catalog; a shard written in
        place is written on every rank, so the ranks rebuild together."""
        part = self.partitioner
        tu, ti = self._train_rows(train)
        cache = self.__dict__.setdefault("_serving_cache", {})
        if cache.get("V") != psrv.catalog_version(self.V):
            cache["catalog"] = psrv.catalog_from_shard(
                self.V, part, item_mask=np.asarray(self.items.ids) >= 0)
            cache["V"] = cache["catalog"].version
        if cache.get("U") != psrv.catalog_version(self.U):
            cache["U_all"] = part.gather(self.U, "users", "rank")
            cache["U"] = psrv.catalog_version(self.U)
        return _mesh_top_ids(self.users, self.items, cache["U_all"],
                             cache["catalog"], user_ids, k=k,
                             train=(tu, ti), chunk=chunk,
                             return_mask=return_mask)

    _train_rows = MFModel._train_rows
