"""Runs of one cell, each a process of its own, and their spread.

    python3 benchmark/tools/runs.py --workload <cell> --seeds S1,S2,... \\
        [--seconds 51] [--trace 0] [--out DIR]

Runs `benchmark/run.py` once a seed, in turn, keeps each run's standard
output and error under DIR, and prints one JSON line a run: its metrics,
`correct`, the checks and, for an offline cell, its rate in each whole
10 s of the window (from the `# window` note's batch stamps).
The last line gives each metric's median and spread over the runs: the
distance between the first and third quartiles of
`statistics.quantiles(values, n=4)` over the median, the measure the
bounds of `BENCHMARK.json` are set from (PERF.md).
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness.manifest import load_cell  # noqa: E402


def rate_by_10s(stamps, batch: int):
    """Images a second in each whole 10 s of the window, from the times
    (s after the window opened) at which each batch was written: over the
    batches written inside the 10 s, first to last."""
    out = []
    for a in range(0, int(max(stamps, default=0.0)) - 9, 10):
        i = bisect.bisect_left(stamps, a)
        j = bisect.bisect_left(stamps, a + 10) - 1
        if j > i:
            out.append(batch * (j - i) / (stamps[j] - stamps[i]))
    return out


def notes(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("# ") and ": " in line:
            key, value = line[2:].split(": ", 1)
            out[key] = json.loads(value)
    return out


def spread(values) -> dict:
    med = statistics.median(values)
    if len(values) < 2:
        return {"median": med, "spread": None, "n": len(values)}
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "spread": (q3 - q1) / med, "n": len(values)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers, one run each")
    ap.add_argument("--seconds", type=int, default=51)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "runs"))
    args = ap.parse_args()
    batch = load_cell(args.workload).config["ttl"]["sample_batch"]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    values = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        stem = f"{args.workload}.{i}.{seed}.{args.trace}"
        (out_dir / f"{stem}.out").write_text(proc.stdout)
        (out_dir / f"{stem}.err").write_text(proc.stderr)
        row = {"workload": args.workload, "seed": seed,
               "rc": proc.returncode}
        lines = proc.stdout.strip().splitlines()
        if proc.returncode == 0 and lines:
            line = json.loads(lines[-1])
            row.update(correct=line["correct"],
                       metrics={k: v["value"]
                                for k, v in line["metrics"].items()},
                       checks={k: v["value"]
                               for k, v in line["checks"].items()},
                       memory_peak_bytes=line["device"]["memory_peak_bytes"])
            for k, v in row["metrics"].items():
                values.setdefault(k, []).append(v)
            window = notes(proc.stdout).get("window", {})
            if "batch_s" in window:
                row["rate_by_10s"] = rate_by_10s(window["batch_s"], batch)
            row["card"] = notes(proc.stdout).get("card")
        else:
            row["stderr_tail"] = proc.stderr[-2000:]
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload,
                      "spread": {k: spread(v) for k, v in values.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
