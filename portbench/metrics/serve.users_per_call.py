"""``serve.users_per_call``: the users a window's ``serve`` call scored, on
average (the engine's own counters ``stats["rows"]`` over
``stats["flushes"]``): how full the engine's batches ran."""


def read(ctx):
    flushes = ctx.facts.get("window_flushes")
    if not flushes:
        return None
    return ctx.facts["window_rows"] / flushes
