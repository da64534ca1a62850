"""``dsgd.plan_ms``: a DSGD fit's step plan, in ms: the card's time inside
the program's ``dsgd/plan`` spans (``build_step_plan``; a CUDA event pair
each) over the traced fits."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "dsgd/plan", "device_ms", "traced_fits")
