"""Factor initializers (counterpart of
``large_scale_recommendation_tpu.core.initializers``).

Initializers are batched functions ``ids -> [n, rank]`` tables. Two
semantics, as in the JAX package, plus ``FunctionFactorInitializer`` around
any such function, and ``init_table`` for ids ``[0, num_rows)``:

- ``PseudoRandomFactorInitializer``: a row is a function of its id alone.
  Each entry is a counter-based hash of (id, column) in integer torch ops,
  so the same id maps to the same vector on every call, every worker and
  every device (the CPU and the card give the same bits).
- ``RandomFactorInitializer``: fresh uniform[0, 1) draws from one stream
  generator keyed by ``(seed, salt)``.

Neither reproduces JAX's threefry draws, so the port's tables differ from
the JAX package's for the same seed; parity tests carry the JAX tables
across instead (``convert.factors_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

# keys of the stream initializer: (seed, salt) → one 63-bit generator seed
_SALT_STRIDE = 1_000_003

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # column stride of the keyed hash
_ID_SALT = 0x5BD1E995  # mixed into the high id word
_ROW_CHUNK = 1 << 16  # rows per pass: bounds the int64 temporaries


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32), in two 16-bit halves of c
    so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection on [0, 2^32))."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keyed_uniform_rows(ids: torch.Tensor, rank: int,
                       scale: float) -> torch.Tensor:
    """rows[j, c] = scale · u(ids[j], c), u a 24-bit uniform in [0, 1) from
    a keyed hash of (id, column). Integer ops and one exact f32 scaling:
    bit-equal on any device. Returns float32 on ``ids``' device."""
    ids = ids.to(torch.int64)
    out = torch.empty((ids.shape[0], rank), dtype=torch.float32,
                      device=ids.device)
    cols = _mul32(torch.arange(1, rank + 1, dtype=torch.int64,
                               device=ids.device), _GOLDEN)
    s = float(np.float32(scale))
    for a in range(0, ids.shape[0], _ROW_CHUNK):
        chunk = ids[a:a + _ROW_CHUNK]
        key = _mix32((chunk & _M32) ^ _mix32(((chunk >> 32) & _M32)
                                             ^ _ID_SALT))
        h = _mix32(_mix32(key[:, None] ^ cols[None, :]))
        out[a:a + _ROW_CHUNK] = (h >> 8).to(torch.float32) * (2.0 ** -24)
    return out.mul_(s)


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

    def open(self) -> "RandomFactorInitializer":
        return self


@dataclasses.dataclass(frozen=True)
class PseudoRandomFactorInitializer:
    """Deterministic per-id factors: row = f(id) only. Tensor ids give a
    table on their device; other ids (numpy, lists) a CPU table."""

    rank: int
    scale: float = 1.0

    def __call__(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = torch.as_tensor(np.asarray(ids, dtype=np.int64))
        return keyed_uniform_rows(ids, self.rank, self.scale)

    def open(self) -> "PseudoRandomFactorInitializer":
        return self


@dataclasses.dataclass(frozen=True)
class FunctionFactorInitializer:
    """Wrap an arbitrary ``ids -> [n, rank]`` function."""

    rank: int
    fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, ids) -> torch.Tensor:
        return self.fn(ids)

    def open(self) -> "FunctionFactorInitializer":
        return self


def init_table(initializer, num_rows: int,
               rank: int | None = None) -> torch.Tensor:
    """A full factor table for ids ``[0, num_rows)`` (an int64 CPU tensor;
    ``rank`` is the initializer's own)."""
    del rank
    return initializer(torch.arange(num_rows, dtype=torch.int64))
