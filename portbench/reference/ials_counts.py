"""The least time of an implicit ALS (iALS) half-step on the card at rank
k, worked out from the inputs alone (never from anything the program
builds): the larger of its FLOPs over the f32 peak and its bytes over the
HBM bandwidth.

FLOPs (an FMA counts 2, an add, multiply or reciprocal square root 1):
- an entry (a pair of the solved row): its weighted outer product's lower
  triangle, k(k+1)/2 FMAs, and its term of b, k FMAs;
- a solved row: the whole-table gram's lower triangle added, k(k+1)/2
  adds, the ridge, k adds; the Cholesky factorisation, (k³ − k)/6 FMAs of
  the trailing updates, k(k − 1)/2 multiplies of the columns and k pivots
  (a reciprocal square root and a multiply each); the forward and back
  solves, k(k − 1)/2 FMAs and k multiplies each.

Bytes: an entry's partner row (4k B, gathered once an entry: the fixed
tables outgrow the L2) with its column, value and weight (12 B); a solved
row's output row (4k B).

Over several half-steps the FLOPs and the bytes add up entry by entry and
row by row; the larger of the two sums is the sum of the half-steps'
least times where each is bound the same way, and less otherwise, so a
share of it never reads high.

The whole-table gram YᵀY of an N-row table (``als/full_gram``) is
2·N·k² FLOPs and its N·k·4 bytes read once.
"""

from __future__ import annotations

from portbench.reference.peaks import least_seconds

ENTRY_EXTRA_BYTES = 12  # column (int32), value and gram weight (f32)


def half_step_flops(rows: int, entries: int, rank: int) -> float:
    k = float(rank)
    per_entry = 2.0 * (k * (k + 1) / 2 + k)
    factor = 2.0 * (k ** 3 - k) / 6 + k * (k - 1) / 2 + 2 * k
    solves = 2 * (2.0 * k * (k - 1) / 2 + k)
    per_row = k * (k + 1) / 2 + k + factor + solves
    return entries * per_entry + rows * per_row


def half_step_bytes(rows: int, entries: int, rank: int) -> float:
    return (float(entries) * (4 * rank + ENTRY_EXTRA_BYTES)
            + float(rows) * 4 * rank)


def half_step_least_seconds(rows: int, entries: int, rank: int) -> float:
    """The least seconds of half-steps that solved ``rows`` rows with
    ``entries`` pairs in all, at rank ``rank``."""
    return least_seconds(half_step_bytes(rows, entries, rank),
                         half_step_flops(rows, entries, rank))[0]


def full_gram_flops(n: int, rank: int) -> float:
    return 2.0 * n * rank * rank


def full_gram_bytes(n: int, rank: int) -> float:
    return 4.0 * n * rank
