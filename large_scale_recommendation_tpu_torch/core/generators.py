"""Synthetic rating workloads (counterpart of
``large_scale_recommendation_tpu.core.generators``).

A numpy copy: the same seed gives the same ratings, bit for bit, as the JAX
package's generator, so both packages can be fed one workload.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from large_scale_recommendation_tpu_torch.core.types import Ratings


def _next_exp_discrete(
    rng: np.random.Generator, lam: float, n: int, size: int
) -> np.ndarray:
    """Discretized truncated-exponential draw in [0, n): floor(n·(−ln(1−x)/λ))
    with rejection resampling of the rare overshoot beyond n."""
    out = np.empty(size, dtype=np.int64)
    remaining = np.arange(size)
    while remaining.size:
        x = rng.random(remaining.size)
        v = np.floor(np.log1p(-x) / (-lam) * n).astype(np.int64)
        ok = v <= n
        out[remaining[ok]] = v[ok]
        remaining = remaining[~ok]
    return np.minimum(out, n - 1)  # clamp the x == n edge into the id range


@dataclasses.dataclass
class SyntheticMFGenerator:
    """Ratings drawn from a planted low-rank model: r = u·v + noise with
    known ground-truth factors, so RMSE targets are meaningful."""

    num_users: int
    num_items: int
    rank: int
    noise: float = 0.1
    seed: int = 0
    skew_lam: float | None = None  # if set, draw ids exponentially

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.true_u = rng.normal(0, 1.0 / np.sqrt(self.rank),
                                 (self.num_users, self.rank)).astype(np.float32)
        self.true_v = rng.normal(0, 1.0 / np.sqrt(self.rank),
                                 (self.num_items, self.rank)).astype(np.float32)
        self._rng = rng

    def generate(self, n: int) -> Ratings:
        if self.skew_lam is not None:
            users = _next_exp_discrete(self._rng, self.skew_lam,
                                       self.num_users, n)
            items = _next_exp_discrete(self._rng, self.skew_lam,
                                       self.num_items, n)
        else:
            users = self._rng.integers(0, self.num_users, n)
            items = self._rng.integers(0, self.num_items, n)
        r = np.einsum("nk,nk->n", self.true_u[users], self.true_v[items])
        r = r + self._rng.normal(0, self.noise, n)
        return Ratings.from_arrays(users, items, r.astype(np.float32))
