#!/usr/bin/env python
"""Throughput of several archs on the PyTorch port: one command, one JSON
line. The counterpart of tools/bench_arches.py; each row is measured as
bench_torch.py measures its headline (best-of-W windows of N steps for wall,
a short torch.profiler trace for device busy time), and prints the kernel
launches of its first step:

  ViT-B/16            the headline config (comparable to bench_torch.py)
  ViT-L/14            arch-relative LoRA window -> layers 21-23
  ViT-B/32            the small/fast ViT
  RN50 + text-LoRA    the ResNet tower with the adapted text encoder
                      (RN50's attention-pool vision tower carries no LoRA
                      window, as the reference targets ViT q/v only)

Usage (on the card; TTL_BENCH_PLATFORM=cpu runs the plain versions):
  python tools/torch_bench_arches.py                  # all rows
  python tools/torch_bench_arches.py --rows ViT-B/32  # a subset
  TTL_BENCH_PLATFORM=cpu python tools/torch_bench_arches.py \\
      --rows test-tiny,test-tiny:text --s 2 --windows 1 --iters 2

Prints one JSON line; `--out` also writes it to a file. It never writes
BENCH_ARCHES.json, the JAX package's record.
A row that raises is recorded with its error, the other rows still run, and
the exit code is then 1. Rows stop early once TTL_BENCH_BUDGET_S (default
1500 s) has less than 60 s left; `missing_rows` lists what did not run.
"""
import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (make_step, measure, busy_ms_for, device)
from ttl_tpu_torch.config import resolve_layer_range  # noqa: E402
from ttl_tpu_torch.runner import full_f32_products  # noqa: E402

DEFAULT_ROWS = ["ViT-B/16", "ViT-L/14", "ViT-B/32", "RN50:text"]


def measure_row(row: str, args, device) -> dict:
    """One row (ARCH, or ARCH:text for text-LoRA) at `args.s` samples."""
    clip_cfg, cfg, params, adapters0, canv, hs, ws = bench_torch.bench_inputs(
        row, args.s, device)
    text_cls = bench_torch.classifier(params, clip_cfg, args.classes)
    tokens = (bench_torch.class_tokens(args.classes)
              if cfg.lora_encoder == "text" else None)
    step, S = bench_torch.make_step(clip_cfg, cfg, params, text_cls,
                                    adapters0, canv, hs, ws, tokens=tokens)
    launches = bench_torch.step_launches(step)
    wall = bench_torch.measure(clip_cfg, cfg, params, text_cls, adapters0,
                               canv, hs, ws, windows=args.windows,
                               iters=args.iters, step=step)
    entry = {"row": row, "arch": cfg.arch, "lora_encoder": cfg.lora_encoder,
             "layer_range": list(resolve_layer_range(cfg, clip_cfg)),
             "resolution": cfg.resolution, "wall_sps": round(wall, 3),
             "launches": launches}
    busy = bench_torch.busy_ms_for(step, device)
    if busy:
        entry["busy_ms_per_step"] = round(busy, 3)
        entry["busy_sps"] = round(S / (busy / 1000.0), 3)
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=",".join(DEFAULT_ROWS),
                    help="comma-separated ARCH or ARCH:text rows")
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--s", type=int, default=8)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if args.out and pathlib.Path(args.out).resolve() == (
            ROOT / "BENCH_ARCHES.json"):
        ap.error("BENCH_ARCHES.json is the JAX package's record")

    t_start = time.time()
    budget = float(os.environ.get("TTL_BENCH_BUDGET_S", "1500"))
    device = bench_torch.bench_device()
    full_f32_products(device)
    rows_wanted = [r for r in args.rows.split(",") if r]
    out = {"metric": "adapted samples/sec/chip per arch (64-view TTL step)",
           "unit": "samples/s/chip", "classes": args.classes,
           "sample_batch": args.s,
           "device": bench_torch.device_info(device, 1), "rows": [],
           "missing_rows": list(rows_wanted)}
    failed = False
    for row in rows_wanted:
        t_row = time.time()
        try:
            entry = measure_row(row, args, device)
        except Exception as e:  # one broken row must not lose the others
            entry = {"row": row, "error": f"{type(e).__name__}: {e}"}
            failed = True
        entry["elapsed_s"] = round(time.time() - t_row, 1)
        out["rows"].append(entry)
        out["missing_rows"].remove(row)
        print(f"torch_bench_arches: {row}: {entry}", file=sys.stderr,
              flush=True)
        if budget - (time.time() - t_start) < 60 and out["missing_rows"]:
            print(f"torch_bench_arches: budget spent; missing "
                  f"{out['missing_rows']}", file=sys.stderr, flush=True)
            break
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
