"""``serve.assemble_ms``: the result assembly of one ``serve`` call, in
ms: the wall of the program's ``serving/assemble`` spans (row-space top-K
to item ids, a ``RecResult`` per request) over the traced calls."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "serving/assemble", "wall_ms", "traced_calls")
