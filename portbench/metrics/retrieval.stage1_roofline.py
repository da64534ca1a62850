"""``retrieval.stage1_roofline``: stage 1's share of its roofline, in %:
the least time of the traced calls' stage 1 (``reference/retrieval_counts``,
from the real query rows the program's ``serving/stage1`` spans count, the
configuration's catalog and rank, and the traced calls), over the card's
time inside those spans."""

from portbench.reference.retrieval_counts import stage1_least_seconds


def read(ctx):
    try:
        from large_scale_recommendation_tpu_torch.obs.trace import (
            span_totals)

        row = span_totals().get("serving/stage1")
    except (ImportError, AttributeError):
        return None
    calls = ctx.facts.get("traced_calls") or 0
    if row is None or not row.get("device_ms") or not calls:
        return None
    rows = row.get("args", {}).get("rows")
    if not rows:
        return None
    least = stage1_least_seconds(
        rows, int(ctx.config["data"]["num_items"]),
        int(ctx.config["serve"]["num_factors"]), calls)
    return 100.0 * least / (1e-3 * row["device_ms"])
