"""``device_idle.stream``: the share of the traced stream window in which
no kernel, copy or set ran on the card, in %."""

from portbench.trace import idle_share


def read(ctx):
    return idle_share(ctx.profile)
