"""A fault planted in the adaptive model's swap, to show that an adaptive
cell's check catches it, and the readings with it.

    python3 portbench/adaptive_faults.py --workload <cell> --seeds 1,2,3
        --fault install_skipped --seconds <s>

``plant(patch, fault)`` patches ``models/adaptive.py``:

- ``install_skipped``: every swap of the device route leaves the live
  tables as they were (the retrain runs, its rows are never copied in).

The retrain's own faults are ``faults.py``'s for ``dsgd`` (the cell's
mix names that solver: ``readings.py --fault``), the online step's those
for ``online``. A line a run, then the smallest reading of every number.
A tool for setting limits on the card: the benchmark's runs never call
it. ``patch`` is anything with ``setattr(obj, name, value)`` that undoes
itself (pytest's ``monkeypatch``, or ``faults.Patch``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults, harness, readings  # noqa: E402

FAULTS = ("install_skipped",)


def plant(patch, fault: str) -> None:
    from large_scale_recommendation_tpu_torch.models import adaptive

    if fault != "install_skipped":
        raise ValueError(f"no fault {fault!r} of the adaptive model")
    patch.setattr(adaptive.AdaptiveMF, "_install_rows",
                  lambda self, model: None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    args = ap.parse_args(argv)
    harness.pin_caches()
    patch = faults.Patch()
    plant(patch, args.fault)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    try:
        rows = readings.readings(args.workload, seeds, args.seconds)
    finally:
        patch.undo()
    kind = "fault_" + args.fault
    for row in rows:
        print(json.dumps({"kind": kind, **row}), flush=True)
    names = [n for n in rows[0] if n not in ("seed", "correct", "wall_s")]
    print(json.dumps({"workload": args.workload, "summary": {
        kind: {n: min(r[n] for r in rows) for n in names}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
