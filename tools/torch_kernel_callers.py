"""Who launches the top device operations of an adapted Bongard pass, on
one card.

One adapted pass of `adapt.bongard.evaluate_bongard` at ViT-B/16 (random
weights from seed 0) over `chip_smoke.py`'s four synthetic episodes
(phase 30), after one warm pass, traced with Python stacks
(`utils.profiling.trace(..., with_stack=True)`). For each of the `--top`
device operations by time: the innermost frames in ttl_tpu_torch around
the runtime calls that launched it, the operator that made the call and
the autograd node it ran in, with launches and device ms. A launch's
`correlation` id names its kernel and its `External id` its operator;
frames and nodes enclose the launch on its thread, and a backward runs on
autograd's own thread, without Python frames.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 tools/torch_kernel_callers.py [--top 10]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_callers(fn, top: int) -> str:
    """fn() traced with Python stacks: for each of its `top` device
    operations by time, its launchers with their launches and device ms,
    as lines."""
    from ttl_tpu_torch.utils.profiling import (DEVICE_CATEGORIES, op_stats,
                                               trace)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, "cuda", with_stack=True):
            fn()
        rows = op_stats(tmp, top)
        with open(glob.glob(os.path.join(tmp, "*.pt.trace.json"))[0]) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    names = {r["operation"] for r in rows}
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in DEVICE_CATEGORIES and e["name"] in names
               and "correlation" in e.get("args", {})}
    calls, nodes, ops = defaultdict(list), defaultdict(list), {}
    for e in events:
        if e.get("cat") == "python_function" and "ttl_tpu_torch" in e["name"]:
            calls[e["tid"]].append(e)
        elif e.get("cat") == "cpu_op":
            ops[e.get("args", {}).get("External id")] = e["name"]
            if e["name"].startswith("autograd::engine::evaluate_function"):
                nodes[e["tid"]].append(e)

    def around(spans, e):
        """The spans enclosing e, innermost first."""
        return sorted((c for c in spans if c["ts"] <= e["ts"]
                       and c["ts"] + c["dur"] >= e["ts"] + e["dur"]),
                      key=lambda c: -c["ts"])

    by_caller = defaultdict(lambda: [0, 0.0])
    for e in events:
        k = kernels.get(e.get("args", {}).get("correlation")) \
            if e.get("cat") in ("cuda_runtime", "cuda_driver") else None
        if k is None:
            continue
        where = " < ".join(re.sub(r".*ttl_tpu_torch/", "", c["name"])
                           for c in around(calls[e["tid"]], e)[:3])
        op = ops.get(e.get("args", {}).get("External id"), "no operator")
        node = [c["name"].split(": ")[-1] for c in around(nodes[e["tid"]], e)]
        entry = by_caller[k["name"], f"{where or 'no package frame'} ({op}"
                          + (f" in {node[0]})" if node else ")")]
        entry[0] += 1
        entry[1] += float(k["dur"])
    lines = []
    for r in rows:
        lines.append(f"  {r['self_time_us'] / 1e3:9.3f} ms "
                     f"{r['occurrences']:6d}x  {r['operation'][:120]}")
        for (name, where), (n, us) in sorted(by_caller.items(),
                                             key=lambda kv: -kv[1][1]):
            if name == r["operation"]:
                lines.append(f"      {n:6d}x {us / 1e3:9.3f} ms at {where}")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=10,
                    help="device operations to name the launchers of")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_callers: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt import bongard
    from ttl_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = _build.build()
    device = torch.device("cuda")
    cfg = cs.config("--test_sets", "bongard")
    clip_cfg, params = runner.load_model(cfg, device)
    adapters0 = runner.make_adapters0(cfg, clip_cfg, device)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        ds = cs.write_bongard(tmp, 4, cs.SEED + 61)

        def evaluate():
            return bongard.evaluate_bongard(cfg, ds, clip_cfg, params,
                                            adapters0, device=device)

        evaluate()
        torch.cuda.synchronize()
        print(f"Bongard, adapted, 4 episodes: the top {args.top} device "
              f"operations and their launchers:\n"
              f"{kernel_callers(evaluate, args.top)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
