"""Factor initializers (counterpart of
``large_scale_recommendation_tpu.core.initializers``).

Two semantics, as in the JAX package:

- ``PseudoRandomFactorInitializer``: a row is a function of its id alone —
  each row is drawn from a ``torch.Generator`` keyed by the id, so the same
  id maps to the same vector on every call and every worker.
- ``RandomFactorInitializer``: fresh uniform[0, 1) draws from one stream
  generator keyed by ``(seed, salt)``.

Torch's Philox/MT streams cannot reproduce JAX's threefry draws, so the
port's tables differ from the JAX package's for the same seed; parity tests
carry the JAX tables across instead (``convert.factors_from_jax``).
Tables are drawn on the host (CPU generators) and returned as CPU float32
tensors; the solver moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# keys of the stream initializer: (seed, salt) → one 63-bit generator seed
_SALT_STRIDE = 1_000_003


def _keyed_uniform_rows(ids, rank: int, scale: float) -> torch.Tensor:
    """rows[j] = scale · uniform[0,1)^rank from a generator seeded by ids[j]."""
    ids = np.asarray(ids, dtype=np.int64)
    out = torch.empty((ids.shape[0], rank), dtype=torch.float32)
    gen = torch.Generator()
    for j, ident in enumerate(ids.tolist()):
        gen.manual_seed(ident)
        torch.rand(rank, generator=gen, out=out[j])
    return out.mul_(scale)


@dataclasses.dataclass(frozen=True)
class RandomFactorInitializer:
    """Uniform[0,1)·scale factors from a keyed stream; ``salt`` separates
    independent streams (the user table vs the item table)."""

    rank: int
    seed: int = 0
    scale: float = 1.0
    salt: int = 0

    def __call__(self, ids) -> torch.Tensor:
        n = np.asarray(ids).shape[0]
        gen = torch.Generator().manual_seed(
            self.seed * _SALT_STRIDE + self.salt)
        return torch.rand((n, self.rank), generator=gen).mul_(self.scale)


@dataclasses.dataclass(frozen=True)
class PseudoRandomFactorInitializer:
    """Deterministic per-id factors: row = f(id) only."""

    rank: int
    scale: float = 1.0

    def __call__(self, ids) -> torch.Tensor:
        return _keyed_uniform_rows(ids, self.rank, self.scale)
