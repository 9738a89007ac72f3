"""Steady samples/s of `chip_smoke.py`'s path phases, this checkout against
another, on one card.

Each side runs in a process of its own, from the root of its checkout, in
the order parent, this, this, parent: for every path named, phase 4's
drive of `runner.run` (16 images for the launch counts, then 80 timed in
the runner's own pipeline, one batch profiled) through that checkout's
`chip_smoke.phase_path`. It prints one JSON line a run and the card's
nvidia-smi line; the two sides build their kernel libraries apart.

Run from the root of the repository, on a machine with the card and nvcc,
with `DIR` the root of a checkout of another commit unpacked inside this
one, in a directory that `.gitignore` lists (for example
`git archive <commit> | tar -x -C build/parent`):

    python3 tools/torch_path_ab.py --parent DIR
        [--paths main text-LoRA zero-shot]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (TTL_FUSED_ATTENTION, CLI flags, launches per batch)
PATHS = {
    "main": (None, (), {"K1": 15, "K2": 3, "K5": 0}),
    "text-LoRA": ("per_head", ("--lora_encoder", "text"),
                  {"K3 fwd": 36, "K3 bwd": 3}),
    "zero-shot": (None, ("--tta_steps", "0", "--prefix_quant", "int8",
                         "--ensemble"), {"K1": 12, "K2": 0, "K5": 72}),
}

RUN = """
import json, sys
import torch
import chip_smoke as cs
from ttl_tpu_torch.ops import _build
from ttl_tpu_torch.ops import attention as fa
from ttl_tpu_torch.ops import quant as tq
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
out = {}
for name, (route, flags, per_batch) in json.loads(sys.argv[1]).items():
    with cs.attention_route(fa, route):
        out[name] = cs.phase_path(fa, tq, name, cs.config(*flags),
                                  per_batch)["samples_per_s"]
print("RESULT " + json.dumps(out), flush=True)
"""


def run_side(checkout: str, paths: dict) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(paths)],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           + proc.stdout[-2000:] + proc.stderr[-4000:])
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the checkout to compare with, inside "
                         "this one (for example build/parent)")
    ap.add_argument("--paths", nargs="+", choices=sorted(PATHS),
                    default=sorted(PATHS))
    args = ap.parse_args()
    paths = {name: PATHS[name] for name in args.paths}
    parent = os.path.abspath(args.parent)
    if parent == ROOT or os.path.commonpath([parent, ROOT]) != ROOT:
        ap.error("--parent must lie inside this checkout, in a directory "
                 ".gitignore lists (for example build/parent)")
    for side, checkout in (("parent", parent), ("this", ROOT),
                           ("this", ROOT), ("parent", parent)):
        print(json.dumps({"side": side, "samples_per_s":
                          run_side(checkout, paths)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
