"""Run one cell of BENCHMARK.json on the card and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The run makes its images from the seed, has
the program draw its weights from the seed, measures the cell's traffic
for `--seconds` after set-up, then judges a sample of the program's
answers against the float32 reference (`reference/`). Earlier lines name
the card, sizes, launch counts and the trace's event counts; the last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` a `breakdown`, and last `checks`,
each compared number beside its limit (also the last lines of standard
error).

`--rate` overrides the serve mix's rate, for the sweep that finds the knee
(PERF.md); the driver's runs do not pass it. The check's controls are run
by `tools/readings.py`.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.configure()

from benchmark.harness.session import main  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(parse()))
