"""``adaptive.history_ms``: the adaptive model's history work of one
retrain cycle, in ms: the wall of the program's ``adaptive/history`` spans
(each batch's ids registered and its columns uploaded into the ring, and
the window copied out of the ring in arrival order) over the traced
retrains."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "adaptive/history", "wall_ms", "traced_retrains")
