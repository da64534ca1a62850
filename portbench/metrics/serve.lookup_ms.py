"""``serve.lookup_ms``: the id-to-row lookup of one ``serve`` call, in ms:
the wall of the program's ``serving/lookup`` spans (each flush's
``rows_for`` of every request and the concatenation) over the traced
calls."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "serving/lookup", "wall_ms", "traced_calls")
