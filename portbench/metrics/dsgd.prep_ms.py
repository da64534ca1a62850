"""``dsgd.prep_ms``: the host and device work of a DSGD fit outside its
sweeps (device blocking, the step plan, init, the id maps), in ms a fit:
each window fit's wall (the harness's span) less the device ms of its
training segments (the solver's own CUDA events, ``DSGD.segment_ms``),
averaged over the window's fits."""


def read(ctx):
    walls = ctx.facts.get("window_fit_walls")
    seg = ctx.facts.get("window_counters", {}).get("device_ms_in_segments")
    if not walls or not seg:  # no CUDA events: not a card run
        return None
    return (1e3 * sum(walls) - seg) / len(walls)
