"""``dsgd.mfu``: the DSGD fits' share of the card's f32 peak, in %:
12·rank FLOPs a rating update × the updates of the window's fits, over
the wall of those fits, over 67 TFLOP/s."""

from portbench.reference.counts import sgd_flops_per_rating
from portbench.reference.peaks import F32_FLOP_PER_S


def read(ctx):
    f = ctx.facts
    if not f.get("fits"):
        return None
    rank = ctx.config["dsgd"]["num_factors"]
    flops = sgd_flops_per_rating(rank) * f["nnz"] * f["sweeps"] * f["fits"]
    return 100.0 * flops / f["fit_wall_s"] / F32_FLOP_PER_S
