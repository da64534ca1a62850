"""``serve.exclusion_ms``: the exclusion lists of one ``serve`` call, in
ms: the wall of the program's ``serving/exclusions`` spans (each chunk's
exclusion build and its upload) over the traced calls."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "serving/exclusions", "wall_ms", "traced_calls")
