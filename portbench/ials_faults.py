"""Faults planted in the implicit ALS (iALS) path underneath a run, to show
that an implicit cell's check catches them, and the readings with them.

    python3 portbench/ials_faults.py --plant <fault> --workload <cell>
        --seeds 1,2,3 --seconds <s> [--fault <faults.py's fault>]

``plant(patch, fault)`` patches ``ops/als.py``:

- ``yty_left_out``: every half-step solved without the fixed side's
  whole gram YᵀY (``solve_side``'s ``G`` dropped): the unobserved pairs'
  confidence-1 terms left out;
- ``half_fused``: half of the entries of every fused half-step left out
  (their b-weights and gram weights 0). ``faults.py``'s ``half`` patches
  the bucketed route's ``_gram_chunk``, which the fused kernel never
  calls, so on a card it leaves the fused route as it is.

The rest of the command line is ``readings.py``'s, run with the fault
planted (its rows say ``program``): every row must read ``correct``
false. A tool for setting limits on the card: the benchmark's runs never
call it. ``patch`` is anything with ``setattr(obj, name, value)`` that
undoes itself (pytest's ``monkeypatch``, or ``faults.Patch``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults, harness, readings  # noqa: E402

FAULTS = ("yty_left_out", "half_fused")


def plant(patch, fault: str) -> None:
    from large_scale_recommendation_tpu_torch.ops import als

    if fault == "yty_left_out":
        orig = als.solve_side

        def solve(factors, prepared, num_rows, lambda_, G=None, dtype=None):
            return orig(factors, prepared, num_rows, lambda_, None,
                        dtype=dtype)

        patch.setattr(als, "solve_side", solve)
    elif fault == "half_fused":
        orig = als.als_solve

        def solve(F, plan, lambda_, G=None):
            w = (plan.vals.new_ones(plan.vals.shape) if plan.w is None
                 else plan.w.clone())
            vals = plan.vals.clone()
            w[1::2] = 0.0
            vals[1::2] = 0.0
            return orig(F, dataclasses.replace(plan, vals=vals, w=w),
                        lambda_, G)

        patch.setattr(als, "als_solve", solve)
    else:
        raise ValueError(f"no fault {fault!r} of the implicit path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plant", choices=FAULTS, required=True)
    args, rest = ap.parse_known_args(argv)
    harness.pin_caches()
    patch = faults.Patch()
    plant(patch, args.plant)
    try:
        return readings.main(rest)
    finally:
        patch.undo()


if __name__ == "__main__":
    sys.exit(main())
