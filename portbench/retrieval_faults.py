"""Faults planted in the two-stage retriever's timed path, to show that a
two-stage cell's check catches them, and the readings with them or with
a second control.

    python3 portbench/retrieval_faults.py --workload <cell> --seeds 1,2,3
        (--fault half|altered | --control <key>) --seconds <s>

``plant(patch, fault)`` patches ``serving/retrieval.py`` where
``TwoStageRetriever.topk`` looks it up (the card's route and the CPU's
alike):

- ``half``: half of the catalog left out of every call's stage 1 (the odd
  rows at the dead slot's weight, so they never become candidates);
- ``altered``: one answer altered where stage 2 produces it (the first
  query's best score of every chunk, by ``faults.ALTER``).

``--control <key>`` merges the limits file's entry ``<key>`` into the
configuration, as ``readings.py`` merges its ``control``. A line a run,
then the smallest reading of every number. A tool for setting limits on
the card: the benchmark's runs never call it. ``patch`` is anything with
``setattr(obj, name, value)`` that undoes itself (pytest's
``monkeypatch``, or ``faults.Patch``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults, harness, readings  # noqa: E402

FAULTS = ("half", "altered")


def plant(patch, fault: str) -> None:
    from large_scale_recommendation_tpu_torch.serving import retrieval
    from large_scale_recommendation_tpu_torch.utils.metrics import (
        DEAD_SLOT_OFFSET)

    if fault == "half":
        orig = retrieval._stage1_flat

        def stage1(qU, u_scale, Q, scale, item_w, *a, **k):
            item_w = item_w.clone()
            item_w[1::2] = DEAD_SLOT_OFFSET
            return orig(qU, u_scale, Q, scale, item_w, *a, **k)

        patch.setattr(retrieval, "_stage1_flat", stage1)
    elif fault == "altered":
        orig = retrieval._stage2

        def stage2(*a, **k):
            vals, rows = orig(*a, **k)
            vals = vals.clone()
            vals[0, 0] += faults.ALTER
            return vals, rows

        patch.setattr(retrieval, "_stage2", stage2)
    else:
        raise ValueError(f"no fault {fault!r} of the two-stage retriever")


def control_override(workload: str, key: str) -> dict:
    """The limits file's entry ``key`` merged into the cell's
    configuration."""
    cell = harness.resolve(workload)
    ctl = harness.load_json(os.path.join(
        harness.BENCH_DIR, "limits", workload + ".json"))[key]
    return {name: ({**cell.config[name], **val} if isinstance(val, dict)
                   else val) for name, val in ctl.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--fault", choices=FAULTS)
    what.add_argument("--control")
    args = ap.parse_args(argv)
    harness.pin_caches()
    patch = faults.Patch()
    override = None
    if args.fault is not None:
        plant(patch, args.fault)
        kind = "fault_" + args.fault
    else:
        override = control_override(args.workload, args.control)
        kind = args.control
    seeds = [int(s) for s in args.seeds.split(",") if s]
    try:
        rows = readings.readings(args.workload, seeds, args.seconds,
                                 override)
    finally:
        patch.undo()
    for row in rows:
        print(json.dumps({"kind": kind, **row}), flush=True)
    names = [n for n in rows[0] if n not in ("seed", "correct", "wall_s")]
    print(json.dumps({"workload": args.workload, "summary": {
        kind: {n: min(r[n] for r in rows) for n in names}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
