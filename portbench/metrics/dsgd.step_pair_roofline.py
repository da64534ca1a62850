"""``dsgd.step_pair_roofline``: the DSGD step pair's share of its
roofline, in %: the least time of the traced fits' sweeps (summed step by
step from the blocked ratings, ``reference/counts.dsgd_step_bounds``) over
the time of the pair's kernels (``sgd_item_rows_kernel``,
``sgd_user_rows_kernel``) in the traced window."""

from portbench.trace import kernel_seconds


def read(ctx):
    bound = ctx.facts.get("step_bounds_s")
    if ctx.profile is None or bound is None:
        return None
    spent = kernel_seconds(ctx.profile, "sgd_item_rows", "sgd_user_rows")
    if spent <= 0:
        return None
    sweeps = ctx.facts["sweeps"] * ctx.facts["traced_fits"]
    return 100.0 * bound * sweeps / spent
