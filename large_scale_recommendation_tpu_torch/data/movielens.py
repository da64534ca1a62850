"""MovieLens-shaped synthetic workloads (counterpart of ``synthetic_like``
and ``_SHAPES`` in ``large_scale_recommendation_tpu.data.movielens``; the
file loaders come in a later slice)."""

from __future__ import annotations

from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings

_SHAPES = {
    # name: (num_users, num_items, nnz)
    "ml-100k": (943, 1682, 100_000),
    "ml-1m": (6_040, 3_706, 1_000_209),
    "ml-25m": (162_541, 59_047, 25_000_095),
    "netflix": (480_189, 17_770, 100_480_507),
}


def synthetic_like(name: str, nnz: int | None = None, rank: int = 16,
                   noise: float = 0.3, seed: int = 0,
                   skew_lam: float = 2.0,
                   num_users: int | None = None,
                   num_items: int | None = None) -> tuple[Ratings, Ratings]:
    """A planted-low-rank workload with the named dataset's shape (skewed id
    draws). Returns (train, test), split 95/5 by volume."""
    if name not in _SHAPES:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_SHAPES)}")
    nu, ni, n = _SHAPES[name]
    nu = int(num_users) if num_users is not None else nu
    ni = int(num_items) if num_items is not None else ni
    n = nnz if nnz is not None else n
    gen = SyntheticMFGenerator(num_users=nu, num_items=ni, rank=rank,
                               noise=noise, seed=seed, skew_lam=skew_lam)
    return gen.generate(int(n * 0.95)), gen.generate(n - int(n * 0.95))
