"""``serve.call_ms``: the mean wall of a window's ``ServingEngine.serve``
call, in ms (the harness's span around each call: the engine's host
staging, the card's scoring and top-K, the drain of the answers)."""


def read(ctx):
    walls = ctx.facts.get("window_call_walls")
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
