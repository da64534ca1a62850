"""``ials.full_gram_ms``: the whole-table grams YᵀY of an iALS round, in
ms: the card's time inside the program's ``als/full_gram`` spans (one a
half-step) over the traced rounds."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "als/full_gram", "device_ms", "traced_fits",
                    "sweeps")
