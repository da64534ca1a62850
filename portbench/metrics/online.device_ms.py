"""``online.device_ms``: the card's kernel, copy and set time of one
online micro-batch, in ms: the traced window's device records summed, over
its batches."""


def read(ctx):
    if (ctx.profile is None or not ctx.profile.kernels
            or not ctx.facts.get("traced_batches")):
        return None
    spent = sum(ctx.profile.kernels.values())
    return 1e3 * spent / ctx.facts["traced_batches"]
