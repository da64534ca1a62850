"""``als.round_ms``: an ALS round's device ms (the solver's own CUDA
events, ``ALS.round_ms``), averaged over the window's rounds."""


def read(ctx):
    c = ctx.facts.get("window_counters", {})
    if not c.get("rounds"):
        return None
    return c["round_ms_sum"] / c["rounds"]
