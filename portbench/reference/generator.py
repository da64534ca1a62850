"""The traffic generator: planted low-rank ratings with skewed ids, made on
one device from a seed.

A frozen copy, rewritten, of the port's ``synthetic_like_device`` path
(``data/device_blocking.py``: ``_generator``, ``truncated_exp_ids``,
``_planted_batch``): factors ``Ut``, ``Vt`` of the planted rank drawn
N(0, 1/rank), ids from a discretized exponential truncated to the id range
(low ids hot, skew λ), ratings ⟨Ut[u], Vt[i]⟩ plus Gaussian noise. Every
draw comes from its own ``torch.Generator`` seeded from ``(seed, stream)``,
so the same seed gives the same inputs on the same device type.
"""

from __future__ import annotations

import numpy as np
import torch

_STREAM_STRIDE = 1_000_003
_SCORE_CHUNK = 1 << 20


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * _STREAM_STRIDE + stream) % (1 << 63))


def exp_ids(u: torch.Tensor, lam: float, n_ids: int) -> torch.Tensor:
    """floor(−log1p(−u·(1−e^{−λ}))/λ · n) clipped to n − 1, int64."""
    u = u * float(np.float32(1.0 - np.exp(-lam)))
    v = torch.floor(-torch.log1p(-u) / lam * n_ids).to(torch.int64)
    return v.clamp_max(n_ids - 1)


def skewed_ids(gen: torch.Generator, lam: float, n_ids: int,
               size: int) -> torch.Tensor:
    u = torch.rand(size, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return exp_ids(u, lam, n_ids)


def planted_factors(seed: int, num_users: int, num_items: int, rank: int,
                    device):
    scale = float(1.0 / np.sqrt(rank))
    Ut = scale * torch.randn((num_users, rank),
                             generator=generator(seed, 1, device),
                             device=device)
    Vt = scale * torch.randn((num_items, rank),
                             generator=generator(seed, 2, device),
                             device=device)
    return Ut, Vt


def planted_ratings(seed: int, batch: int, Ut, Vt, n: int, noise: float,
                    skew: float):
    """``n`` ratings of stream ``batch`` (streams 100·batch + 1..3):
    int64 user and item ids and float32 ratings on ``Ut``'s device."""
    dev = Ut.device
    g_u, g_i, g_r = (generator(seed, 100 * batch + j, dev)
                     for j in range(1, 4))
    u = skewed_ids(g_u, skew, Ut.shape[0], n)
    i = skewed_ids(g_i, skew, Vt.shape[0], n)
    r = torch.empty(n, dtype=torch.float32, device=dev)
    for a in range(0, n, _SCORE_CHUNK):
        b = a + _SCORE_CHUNK
        r[a:b] = (Ut[u[a:b]] * Vt[i[a:b]]).sum(dim=-1)
    r += noise * torch.randn(n, generator=g_r, dtype=torch.float32,
                             device=dev)
    return u, i, r


def dataset(data: dict, seed: int, device):
    """The training ratings of a configuration's ``data`` block: the first
    ``train_fraction`` of ``ratings`` (the 95/5 split by volume; the
    holdout is not drawn). Returns ``(u, i, r)`` on ``device``."""
    nu, ni = int(data["num_users"]), int(data["num_items"])
    n = int(data["ratings"])
    n_train = int(n * float(data.get("train_fraction", 1.0)))
    Ut, Vt = planted_factors(seed, nu, ni, int(data["planted_rank"]),
                             device)
    out = planted_ratings(seed, 1, Ut, Vt, n_train, float(data["noise"]),
                          float(data["skew"]))
    del Ut, Vt
    return out
