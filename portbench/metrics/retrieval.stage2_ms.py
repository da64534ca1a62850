"""``retrieval.stage2_ms``: the two-stage retriever's stage 2 in a call, in
ms: the card's time inside the program's ``serving/stage2`` spans (the
candidates' f32 rows gathered and rescored, the exclusions' membership
test, the top-K; a CUDA event pair each) over the traced calls."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "serving/stage2", "device_ms", "traced_calls")
