"""Power-of-two length buckets (counterpart of
``large_scale_recommendation_tpu.utils.shapes``)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 0; 0 → 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def pow2_pad(n: int, floor: int = 8) -> int:
    """Pad a dynamic length to its pow2 bucket, with a minimum bucket."""
    return max(floor, next_pow2(n))
