"""Read a cell's compared numbers on the card without its measured window's
length: for the control, for a fault planted in the program, or for the
program as it stands. What the limits in `benchmark/workloads/` were set
from (PERF.md, "How `correct` is decided").

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 2]
        [--mode control | sound | fault:<name>]

from the root of a checkout. `control` puts the plain reference (or the
program's own lower-precision path) in the program's place at the
precision just below the configuration's; `fault:<name>` plants the fault
of that name from `uvbench.faults`. Prints one JSON line a seed with every
number compared and its limit.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main() -> int:
    from uvbench import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--mode", default="control")
    args = ap.parse_args()
    fault = args.mode.split(":", 1)[1] if args.mode.startswith("fault:") else None
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload)
        ctx = faults.planted(args.workload, fault) if fault else contextlib.nullcontext()
        with ctx:
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                                   control=args.mode == "control")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "attempted": out["result"]["attempted"],
                          "checks": out["result"]["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
