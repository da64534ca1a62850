"""``dsgd.blocking_ms``: a DSGD fit's device blocking, in ms: the card's
time inside the program's ``dsgd/blocking`` spans (``device_block_problem``;
a CUDA event pair each) over the traced fits."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "dsgd/blocking", "device_ms", "traced_fits")
