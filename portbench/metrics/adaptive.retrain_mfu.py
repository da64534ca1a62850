"""``adaptive.retrain_mfu``: the adaptive retrains' share of the card's f32
peak, in %: 12·rank FLOPs a rating update (``dsgd.mfu``'s count) × the
window's ratings × the sweeps of every traced retrain, over the wall of
the program's ``adaptive/retrain`` spans, over 67 TFLOP/s. Nothing where
the program keeps no such span."""

from portbench.reference.counts import sgd_flops_per_rating
from portbench.reference.peaks import F32_FLOP_PER_S
from portbench.spans import per_unit


def read(ctx):
    f = ctx.facts
    ms = per_unit(ctx, "adaptive/retrain", "wall_ms", "traced_retrains")
    if ms is None:
        return None
    dsgd = ctx.config["dsgd"]
    flops = (sgd_flops_per_rating(dsgd["num_factors"])
             * f["window_ratings"] * dsgd["iterations"])
    return 100.0 * flops / (ms / 1e3) / F32_FLOP_PER_S
