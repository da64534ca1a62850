"""``online.ensure_ms``: the host's vocabulary work of one online
micro-batch, in ms: the wall of the program's ``online/ensure`` spans
(``GrowableFactorTable.ensure`` of both tables: lookup, ``np.unique``,
index merge, install) over the traced batches."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "online/ensure", "wall_ms", "traced_batches")
