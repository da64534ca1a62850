"""``als.gram_ms``: the grams of an ALS round, in ms: the card's time
inside the program's ``als/gram`` spans (each chunk's two ``bmm``) over
the traced rounds."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "als/gram", "device_ms", "traced_fits", "sweeps")
