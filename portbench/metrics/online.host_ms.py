"""``online.host_ms``: the part of an online micro-batch's wall in which
the card did not work for it, in ms: the traced batches' mean wall less
their mean device time (``online.device_ms``)."""


def read(ctx):
    walls = ctx.facts.get("traced_batch_walls")
    if ctx.profile is None or not ctx.profile.kernels or not walls:
        return None
    spent = sum(ctx.profile.kernels.values())
    return 1e3 * (sum(walls) - spent) / len(walls)
