"""Per-layer readings from the program's own spans: the port's span table
(``obs.trace.span_totals()``), which fills only while a profiler records,
so in a ``--trace 1`` run it holds the traced tail alone.

A reader divides a span's total over the tail by the tail's own units
(``traced_batches``, ``traced_fits``, ``traced_calls`` of ``ctx.facts``).
It reads nothing where the program keeps no span table (an older
program), where the span never ran in the tail, or where the field is not
kept (``device_ms`` exists on the card only).
"""

from __future__ import annotations


def per_unit(ctx, name: str, field: str, unit: str,
             times: str | None = None):
    """``field`` (``wall_ms`` or ``device_ms``) of the span ``name`` over
    ``ctx.facts[unit]`` (times ``ctx.facts[times]``); ``None`` where any
    of it is missing."""
    try:
        from large_scale_recommendation_tpu_torch.obs.trace import (
            span_totals)

        row = span_totals().get(name)
    except (ImportError, AttributeError):
        return None
    n = ctx.facts.get(unit) or 0
    if times is not None:
        n *= ctx.facts.get(times) or 0
    if row is None or field not in row or not n:
        return None
    return row[field] / n
