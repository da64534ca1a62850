"""``ials.solve_roofline``: the iALS half-steps' share of their roofline,
in %: the least time of the traced fit's half-steps
(``reference/ials_counts.py``, from the rows and entries the program's
``als/solve`` spans count and the configuration's rank) over the card's
time inside those spans. It reads nothing unless every solved row took
the fused kernel's weighted build (the spans' ``fused`` and ``weighted``
equal to ``rows``): another route's spans are per chunk and time only its
solves."""

from portbench.reference.ials_counts import half_step_least_seconds


def read(ctx):
    try:
        from large_scale_recommendation_tpu_torch.obs.trace import (
            span_totals)

        row = span_totals().get("als/solve")
    except (ImportError, AttributeError):
        return None
    if row is None or not row.get("device_ms"):
        return None
    args = row.get("args", {})
    rows, entries = args.get("rows"), args.get("entries")
    if not rows or not entries or any(
            args.get(name) != rows for name in ("fused", "weighted")):
        return None
    least = half_step_least_seconds(
        rows, entries, int(ctx.config["als"]["num_factors"]))
    return 100.0 * least / (1e-3 * row["device_ms"])
