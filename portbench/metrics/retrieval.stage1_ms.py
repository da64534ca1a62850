"""``retrieval.stage1_ms``: the two-stage retriever's stage 1 in a call, in
ms: the card's time inside the program's ``serving/stage1`` spans (query
quantization, the int8 product over the catalog, scaling, exclusions and
the candidates' selection; a CUDA event pair each) over the traced
calls."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "serving/stage1", "device_ms", "traced_calls")
