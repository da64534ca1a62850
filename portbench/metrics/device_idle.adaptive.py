"""``device_idle.adaptive``: the share of the traced adaptive window (its
online batches and retrains) in which no kernel, copy or set ran on the
card, in %."""

from portbench.trace import idle_share


def read(ctx):
    return idle_share(ctx.profile)
