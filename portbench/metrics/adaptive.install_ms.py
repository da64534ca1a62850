"""``adaptive.install_ms``: one swap's install, in ms: the wall of the
program's ``adaptive/install`` spans (the retrained rows copied into the
live tables by row; the span waits for the copy) over the traced
retrains."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "adaptive/install", "wall_ms", "traced_retrains")
