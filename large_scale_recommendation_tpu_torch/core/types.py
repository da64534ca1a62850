"""Core data types (counterpart of ``large_scale_recommendation_tpu.core.types``).

Ratings travel as struct-of-arrays batches kept on the HOST as numpy
arrays: blocking and vocabulary building consume them there, and the
solvers move the blocked arrays to the device themselves. Padding entries
carry ``weight == 0`` so every kernel can mask them without dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

UserId = int
ItemId = int


@dataclasses.dataclass(frozen=True)
class Ratings:
    """A batch of (user, item, rating) triples in struct-of-arrays form.

    ``weights`` masks padding: real entries have weight 1.0, padding 0.0.
    """

    users: np.ndarray  # int32[n]
    items: np.ndarray  # int32[n]
    ratings: np.ndarray  # float32[n]
    weights: np.ndarray  # float32[n]; 1.0 = real, 0.0 = padding

    @property
    def n(self) -> int:
        return self.users.shape[0]

    @property
    def num_real(self) -> np.float32:
        """Σ weights: the count of real (non-padding) entries."""
        return np.sum(self.weights, dtype=np.float32)

    @staticmethod
    def from_arrays(
        users: Any, items: Any, ratings: Any, weights: Any | None = None
    ) -> "Ratings":
        """Build a host (numpy) batch."""
        users = np.asarray(users, dtype=np.int32)
        items = np.asarray(items, dtype=np.int32)
        ratings = np.asarray(ratings, dtype=np.float32)
        if weights is None:
            weights = np.ones_like(ratings)
        else:
            weights = np.asarray(weights, dtype=np.float32)
        return Ratings(users=users, items=items, ratings=ratings,
                       weights=weights)

    def pad_to(self, n: int) -> "Ratings":
        """Pad with weight-0 entries up to length ``n`` (ids point at row 0;
        weight 0 makes them no-ops in every kernel)."""
        cur = self.n
        if cur > n:
            raise ValueError(f"cannot pad {cur} ratings down to {n}")
        if cur == n:
            return self
        pad = n - cur
        return Ratings(
            users=np.concatenate([self.users, np.zeros(pad, np.int32)]),
            items=np.concatenate([self.items, np.zeros(pad, np.int32)]),
            ratings=np.concatenate([self.ratings, np.zeros(pad, np.float32)]),
            weights=np.concatenate([self.weights, np.zeros(pad, np.float32)]),
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        return (
            np.asarray(self.users),
            np.asarray(self.items),
            np.asarray(self.ratings),
            np.asarray(self.weights),
        )


@dataclasses.dataclass(frozen=True)
class FactorVector:
    """A single (id, factors) pair — the host-side export format."""

    id: int
    factors: np.ndarray

    def __post_init__(self):
        object.__setattr__(
            self, "factors", np.asarray(self.factors, dtype=np.float32)
        )


@dataclasses.dataclass(frozen=True)
class UserUpdate:
    """One updated user vector of the online updates-only output."""

    vector: FactorVector


@dataclasses.dataclass(frozen=True)
class ItemUpdate:
    """One updated item vector of the online updates-only output."""

    vector: FactorVector
