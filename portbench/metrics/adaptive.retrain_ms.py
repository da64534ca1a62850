"""``adaptive.retrain_ms``: one retrain of the adaptive model, in ms: the
wall of the program's ``adaptive/retrain`` spans (the window's DSGD fit:
blocking, plan, init, the sweeps, the id maps; the span waits for the
fitted tables) over the traced retrains."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "adaptive/retrain", "wall_ms", "traced_retrains")
