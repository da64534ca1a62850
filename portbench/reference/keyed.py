"""Per-id keyed uniform rows: ``rows[j, c] = scale · u(ids[j], c)``, with
``u`` a 24-bit uniform in [0, 1) from a keyed hash of (id, column).

A frozen copy, rewritten, of the port's ``keyed_uniform_rows``
(``core/initializers.py``), which every solver of the port uses to start
its tables: the reference starts from the same rows by working them out
from the ids again. Integer ops and one exact f32 scaling, so the rows are
the same bits on any device.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_ID_SALT = 0x5BD1E995
_CHUNK = 1 << 16


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keyed_rows(ids: torch.Tensor, rank: int, scale: float) -> torch.Tensor:
    ids = ids.to(torch.int64)
    out = torch.empty((ids.shape[0], rank), dtype=torch.float32,
                      device=ids.device)
    cols = _mul32(torch.arange(1, rank + 1, dtype=torch.int64,
                               device=ids.device), _GOLDEN)
    for a in range(0, ids.shape[0], _CHUNK):
        chunk = ids[a:a + _CHUNK]
        key = _mix32((chunk & _M32) ^ _mix32(((chunk >> 32) & _M32)
                                             ^ _ID_SALT))
        h = _mix32(_mix32(key[:, None] ^ cols[None, :]))
        out[a:a + _CHUNK] = (h >> 8).to(torch.float32) * (2.0 ** -24)
    return out.mul_(float(np.float32(scale)))
