"""``als.solve_ms``: the solves of an ALS round, in ms: the card's time
inside the program's ``als/solve`` spans (each chunk's batched Cholesky,
two triangular solves and ``index_copy_``) over the traced rounds."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "als/solve", "device_ms", "traced_fits", "sweeps")
