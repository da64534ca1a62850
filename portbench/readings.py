"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and its control's over a few, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,...
        --control-seeds 101,102,103 --seconds <s>

Each seed is one run of the cell (set-up, a window of ``--seconds``, the
check) through the same code as ``run.py``. The control is the cell's
``control`` of ``portbench/limits/<cell>.json``, merged into the
configuration: the program's own path in the nearest precision below the
configuration's, or the plain reference in it put in the program's place.
With ``--fault`` the program runs with that fault of ``faults.py``
planted (give no control seeds then). A line a run, then a summary: the
largest program reading, and the smallest control or fault reading, of
every number. A tool for setting limits on the card: the benchmark's
runs never call it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults, harness  # noqa: E402


def control_override(workload: str) -> dict:
    cell = harness.resolve(workload)
    ctl = harness.load_json(os.path.join(
        harness.BENCH_DIR, "limits", workload + ".json"))["control"]
    out = {}
    for key, val in ctl.items():
        if isinstance(val, dict):
            out[key] = {**cell.config[key], **val}
        else:
            out[key] = val
    return out


def readings(workload: str, seeds, seconds: float, override=None,
             device=None, log=sys.stderr, **kw) -> list[dict]:
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        res = harness.run_cell(workload, seed, seconds, False,
                               config_override=override, device=device,
                               log=log, **kw)
        rows.append({"seed": seed, "correct": res["correct"],
                     "wall_s": time.perf_counter() - t,
                     **{k: v["value"] for k, v in res["compared"].items()}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=faults.FAULTS, default=None)
    args = ap.parse_args(argv)
    harness.pin_caches()
    patch = faults.Patch()
    if args.fault is not None:
        faults.plant(patch, harness.resolve(args.workload).mix["solver"],
                     args.fault)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    summary = {}
    kind0 = "program" if args.fault is None else "fault_" + args.fault
    for kind, ss, over in ((kind0, seeds, None),
                           ("control", ctl_seeds,
                            control_override(args.workload))):
        rows = readings(args.workload, ss, args.seconds, over)
        for row in rows:
            print(json.dumps({"kind": kind, **row}), flush=True)
        names = [k for k in (rows[0] if rows else {})
                 if k not in ("seed", "correct", "wall_s")]
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(r[n] for r in rows) for n in names}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    patch.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
