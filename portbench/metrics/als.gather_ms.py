"""``als.gather_ms``: the gathers of an ALS round, in ms: the card's time
inside the program's ``als/gather`` spans (each chunk's ``index_select``
of the fixed side's rows and the weight multiply) over the traced
rounds."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "als/gather", "device_ms", "traced_fits", "sweeps")
