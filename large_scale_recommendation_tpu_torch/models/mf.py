"""The matrix-factorization model object: factors + scoring + risk
(counterpart of ``large_scale_recommendation_tpu.models.mf``; ``recommend``
and ``ranking_quality`` come in a later slice).

Factors live as dense tables on the model's device; external ids map to
rows through the host-side ``IdIndex`` lookup tables.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.types import FactorVector, Ratings
from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops


def masked_scores(scores, u_mask, i_mask, return_mask: bool):
    """Pairs whose user or item was never seen score 0.0; ``return_mask``
    additionally returns the bool ``seen`` mask."""
    seen = (np.asarray(u_mask) * np.asarray(i_mask)) > 0
    out = np.asarray(scores) * seen
    return (out, seen) if return_mask else out


@dataclasses.dataclass
class MFModel:
    """A trained factorization: U, V on one device + the id maps."""

    U: torch.Tensor  # float32[num_user_rows, rank]
    V: torch.Tensor  # float32[num_item_rows, rank]
    users: IdIndex
    items: IdIndex

    @property
    def device(self) -> torch.device:
        return self.U.device

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

    def user_factors(self) -> Iterator[FactorVector]:
        """(id, factors) for every real user row."""
        U = self.U.float().cpu().numpy()
        for row, ident in enumerate(self.users.ids):
            if ident >= 0:
                yield FactorVector(int(ident), U[row])

    def item_factors(self) -> Iterator[FactorVector]:
        V = self.V.float().cpu().numpy()
        for row, ident in enumerate(self.items.ids):
            if ident >= 0:
                yield FactorVector(int(ident), V[row])
