"""The least time of the two-stage retriever's stage 1, worked out from
the inputs alone (never from anything the program builds).

Stage 1 of a call scores each of the call's ``b`` real query rows against
every one of the catalog's ``N`` rows at rank ``r``: ``2·b·N·r`` integer
operations at the card's dense int8 rate, and the catalog read once, ``r``
bytes of codes and 8 of f32 scale and item weight a row, at the HBM
bandwidth. Nothing is charged for a score matrix, its scaling or the
selection from it (work of an implementation, not of the scores), so no
implementation can take less.

Over many calls the operations add up row by row and the catalog is read
once a call: the larger of the two sums is the sum of the calls' least
times where every call is bound by the same one, and less otherwise, so a
share of it never reads high.
"""

from __future__ import annotations

from portbench.reference.peaks import HBM_BYTES_PER_S

# one NVIDIA H100 SXM, dense int8 on the tensor cores (NVIDIA's data sheet,
# at the full 700 W power limit)
INT8_OP_PER_S = 1979e12
# a catalog row's bytes beside its codes: the f32 scale and item weight
ROW_EXTRA_BYTES = 8


def stage1_least_seconds(rows: int, items: int, rank: int,
                         calls: int = 1) -> float:
    """The least seconds of stage 1 in ``calls`` calls that served
    ``rows`` real query rows in all: the larger of their int8 operations
    over the peak and their catalog bytes over the bandwidth."""
    ops = 2.0 * rows * items * rank
    nbytes = float(calls) * items * (rank + ROW_EXTRA_BYTES)
    return max(ops / INT8_OP_PER_S, nbytes / HBM_BYTES_PER_S)
