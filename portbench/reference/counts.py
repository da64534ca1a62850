"""Operation and byte counts of the work the cells time, worked out from
the inputs alone (never from anything the program builds)."""

from __future__ import annotations

import torch

from portbench.reference.peaks import (
    F32_FLOP_PER_S,
    HBM_BYTES_PER_S,
)

# per rating of a step: user row, item row, rating, weight and the two
# collision scales (4 B each)
STREAM_BYTES_PER_RATING = 24


def sgd_flops_per_rating(rank: int) -> int:
    """FLOPs of one rating's SGD update: the dot (2·rank), the error's
    broadcast, the regularizers and the two deltas with their scales."""
    return 12 * rank


def dsgd_step_bounds(user_rows, item_rows, ratings, *, rank: int) -> float:
    """The least seconds of one DSGD sweep on the card, summed step by
    step: a step's least time is the larger of its bytes over the HBM
    bandwidth and its FLOPs over the f32 peak. A step's bytes: each
    distinct row read and written once with its ω (2·rank·4 + 4 B), plus
    ``STREAM_BYTES_PER_RATING`` a real rating; its FLOPs: 12·rank a rating.
    Arguments are the per-step counts of ``reference.dsgd.step_counts``."""
    row = 2 * rank * 4 + 4
    nbytes = (user_rows + item_rows).double() * row \
        + ratings.double() * STREAM_BYTES_PER_RATING
    flops = ratings.double() * sgd_flops_per_rating(rank)
    least = torch.maximum(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    return float(least.sum())


def als_round_flops(nnz: int, user_rows: int, item_rows: int,
                    rank: int) -> float:
    """FLOPs of one ALS round (both half-steps): per side, grams
    2·nnz·rank² and right-hand sides 2·nnz·rank; per solved row, a
    Cholesky rank³/3 and two triangular solves 2·rank²."""
    r = float(rank)
    per_side = 2.0 * nnz * r * r + 2.0 * nnz * r
    per_row = r ** 3 / 3.0 + 2.0 * r * r
    return 2.0 * per_side + (user_rows + item_rows) * per_row
