"""The readings a cell's limits are set from, in one process on the card.

    python benchmark/tools/readings.py --workload <cell> --seeds N \\
        --control-seeds M [--seconds 4] [--out FILE]

Runs the cell's window (short, at the cell's own load and sizes) and its
check on N seeds as configured, then on M seeds for each control (`fp8`,
the float8 reference in the program's place; `int8`, the program's int8
frozen prefix), and prints one JSON line a run with every
number compared; with --fault-seeds K, also each planted fault
(`harness/faults.py`, or those --faults names) on K seeds. The limits in `workloads/<cell>.json`
are set between the largest sound reading and the smallest control
reading (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.configure()

from benchmark.harness import faults, session  # noqa: E402
from benchmark.harness.device import require_cards  # noqa: E402
from benchmark.harness.manifest import load_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--controls", default="fp8,int8")
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--faults", default=",".join(faults.FAULTS))
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cell = load_cell(args.workload)
    device = require_cards(cell.chips)
    runs = [(args.first_seed + i, None, None) for i in range(args.seeds)]
    for k, control in enumerate(filter(None, args.controls.split(","))):
        runs += [(args.first_seed + 1000 * (k + 1) + i, control, None)
                 for i in range(args.control_seeds)]
    for fault in filter(None, args.faults.split(",")):
        k = faults.FAULTS.index(fault)
        runs += [(args.first_seed + 5000 + 100 * k + i, None, fault)
                 for i in range(args.fault_seeds)]
    sink = open(args.out, "a") if args.out else None
    for seed, control, fault in runs:
        t = time.time()
        with tempfile.TemporaryDirectory() as workdir, \
                faults.patch(fault) if fault else nullcontext():
            res = session.execute(cell, seed, args.seconds, False, device,
                                  t, workdir, control=control)
        row = {"workload": cell.name, "seed": seed, "control": control,
               "fault": fault,
               "answers": res["attempted"],
               "values": {k: v["value"] for k, v in res["checks"].items()},
               "correct": res["correct"], "seconds": time.time() - t}
        print(json.dumps(row), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
