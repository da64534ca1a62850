"""``als.mfu``: the ALS fits' share of the card's f32 peak, in %: the
FLOPs the rounds need (``reference/counts.als_round_flops``) × the rounds
of the window's fits, over the wall of those fits, over 67 TFLOP/s."""

from portbench.reference.peaks import F32_FLOP_PER_S


def read(ctx):
    f = ctx.facts
    if not f.get("fits") or "round_flops" not in f:
        return None
    flops = f["round_flops"] * f["sweeps"] * f["fits"]
    return 100.0 * flops / f["fit_wall_s"] / F32_FLOP_PER_S
