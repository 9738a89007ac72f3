#!/usr/bin/env python
"""Where the wall time of the steady step loop goes on the PyTorch port.

The counterpart of tools/wall_vs_busy.py. Runs the runner's depth-2
pipelined loop (dispatch batch i+1, then drain batch i) with a PhaseTimer
(`utils/profiling.py`) around each phase:

  prep      the batch on the host: its canvases and its view draws
            (`runner.sample_draws`);
  dispatch  the upload (pinned, non-blocking), the fused step and the
            top-k counts: host time to enqueue the work on the card;
  drain     fetching a batch's [3] counts: the wait for the card;

then traces the same loop (torch.profiler) for the device's busy time a
step. wall - busy - prep - dispatch is what neither the device nor the
host's own phases account for where they run one after the other (launch
gaps, the drain's copy); it is negative by as much as the host's phases
overlap the device's work.

  python tools/torch_wall_vs_busy.py --steps 30
  TTL_BENCH_PLATFORM=cpu python tools/torch_wall_vs_busy.py --arch test-tiny \\
      --steps 3 --sample_batch 2 --classes 5

Prints one JSON line; busy time only from a card.
"""
import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench_torch  # noqa: E402  (the device, its name and power limit)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--sample_batch", type=int, default=8)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--arch", default="ViT-B/16")
    args = ap.parse_args(argv)

    import torch

    from ttl_tpu_torch.adapt.ttl import make_fused_ttl_fn
    from ttl_tpu_torch.parallel.eval import make_count_fn
    from ttl_tpu_torch.runner import full_f32_products, sample_draws
    from ttl_tpu_torch.utils.profiling import (PhaseTimer, device_busy_us,
                                               trace)

    device = bench_torch.bench_device()
    full_f32_products(device)
    S = args.sample_batch
    clip_cfg, cfg, params, adapters0, _, _, _ = bench_torch.bench_inputs(
        args.arch, S, device)
    text_cls = bench_torch.classifier(params, clip_cfg, args.classes)
    fused = make_fused_ttl_fn(clip_cfg, cfg)
    count_fn = make_count_fn()
    labels = torch.zeros((S,), dtype=torch.int64, device=device)
    valid = torch.ones((S,), dtype=torch.bool, device=device)
    on_card = device.type == "cuda"
    rng = np.random.RandomState(0)

    def put(t):
        return t.pin_memory().to(device, non_blocking=True) if on_card else t

    def prep(i):
        canv = (rng.rand(S, 512, 512, 3) * 255).astype(np.uint8)
        hs = np.full((S,), 375, np.int32)
        ws = np.full((S,), 500, np.int32)
        draws = sample_draws(cfg, np.arange(S) + i * S)
        return [torch.from_numpy(a) for a in (canv, hs, ws)], draws

    def run_loop(n, timer):
        """The depth-`args.depth` pipelined loop; returns wall seconds."""
        in_flight = []
        t0 = time.perf_counter()
        for i in range(n):
            with timer.phase("prep"):
                host, draws = prep(i)
            with timer.phase("dispatch"):
                res = fused(params, text_cls, adapters0, *map(put, host),
                            {k: put(t) for k, t in draws.items()})
                in_flight.append(count_fn(res.logits, labels, valid))
            if len(in_flight) > args.depth:
                with timer.phase("drain"):
                    in_flight.pop(0).tolist()
        for pending in in_flight:
            with timer.phase("drain"):
                pending.tolist()
        return time.perf_counter() - t0

    run_loop(3, PhaseTimer())  # warm: the kernels' build, the allocator
    tm = PhaseTimer()
    wall = run_loop(args.steps, tm)

    busy_ms = None
    if on_card:
        td = tempfile.mkdtemp(prefix="ttl_wvb_trace_")
        try:
            with trace(td, device):
                run_loop(6, PhaseTimer())
            busy_ms = (device_busy_us(td) or 0) / 6 / 1000.0 or None
        finally:
            shutil.rmtree(td, ignore_errors=True)

    def per_step_ms(name):
        return round(tm.totals[name] / args.steps * 1e3, 3)

    wall_ms = wall / args.steps * 1000.0
    out = {"arch": args.arch, "sample_batch": S, "steps": args.steps,
           "depth": args.depth,
           "device": bench_torch.device_info(device, 1),
           "wall_ms_per_step": round(wall_ms, 3),
           "prep_ms_per_step": per_step_ms("prep"),
           "dispatch_ms_per_step": per_step_ms("dispatch"),
           "drain_ms_per_step": per_step_ms("drain"),
           "wall_sps": round(S / (wall / args.steps), 3)}
    if busy_ms:
        out["busy_ms_per_step"] = round(busy_ms, 3)
        out["busy_equivalent_sps"] = round(S / (busy_ms / 1e3), 3)
        out["unattributed_ms_per_step"] = round(
            wall_ms - busy_ms - out["prep_ms_per_step"]
            - out["dispatch_ms_per_step"], 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
