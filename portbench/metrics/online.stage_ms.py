"""``online.stage_ms``: the padding and host-to-device staging of one
online micro-batch, in ms: the wall of the program's ``online/stage``
spans (``pad_minibatches`` and the copies) over the traced batches."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "online/stage", "wall_ms", "traced_batches")
