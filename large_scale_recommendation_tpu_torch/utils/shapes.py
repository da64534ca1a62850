"""Power-of-two length buckets (counterpart of
``large_scale_recommendation_tpu.utils.shapes``)."""

from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 0; 0 → 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def pow2_pad(n: int, floor: int = 8) -> int:
    """Pad a dynamic length to its pow2 bucket, with a minimum bucket."""
    return max(floor, next_pow2(n))


def pow2_buckets(floor: int = 8, cap: int = 1024) -> tuple[int, ...]:
    """The full bucket family a [floor, cap] pow2 policy can produce: the
    static shape set a serving loop dispatches against (its size, not the
    request count, bounds the number of distinct shapes)."""
    out = []
    b = pow2_pad(floor, floor)  # the caller's floor, rounded up to pow2
    while b <= cap:
        out.append(b)
        b <<= 1
    return tuple(out)


def pad_axis0_pow2(a, floor: int = 8):
    """Zero-pad a numpy array's leading axis to its pow2 bucket (returned
    as is when already there)."""
    n = a.shape[0]
    p = pow2_pad(n, floor)
    if p == n:
        return np.asarray(a)
    out = np.zeros((p,) + a.shape[1:], a.dtype)
    out[:n] = a
    return out
