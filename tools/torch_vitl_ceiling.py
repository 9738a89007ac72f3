#!/usr/bin/env python
"""Ceiling accounting of a ViT arch on the PyTorch port: the exact-FLOP
floor of the benched TTL step against the card's measured device time.

The counterpart of tools/vitl_ceiling.py, with the same FLOP conventions
(the ViT-B/16 9-layer, 64-view prefix comes to 1.68 TFLOP, checked at
every run):

  per-layer-per-view GEMM FLOPs = 24*S*d^2 (qkvo + 4x MLP) + 4*S^2*d
  per-sample = views * (prefix + window) forward
             + window activation-grad backward (1.07x the window forward;
               the tower is frozen: one GEMM per linear, LoRA's are noise)
             + patchify + the single-view adapted clean pass

The floor is stated against the H100's published dense bf16 peak, 989
TFLOP/s (NVIDIA's data sheet, SXM, at its 700 W limit); a measured row
carries the card's name and power limit beside it. On the card it also
runs `bench_torch.make_step` (the benched step) at each S, and splits a
torch.profiler trace's device time into GEMM kernels (cuBLAS, CUTLASS, K5's
int8 product) and the rest: the practical ceiling is the floor at peak
plus that rest.

Usage:
  python tools/torch_vitl_ceiling.py                   # ViT-L/14, S=8
  python tools/torch_vitl_ceiling.py --s_list 4,8,10   # S sweep
  python tools/torch_vitl_ceiling.py --arch ViT-B/16   # the headline arch
  python tools/torch_vitl_ceiling.py --floor-only      # no card needed
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

H100_BF16_TFLOPS = 989.0  # dense bf16, H100 SXM data sheet, 700 W
# substrings of the device kernels that are GEMMs: cuBLAS (nvjet, the
# sm90 xmma/gemm families), CUTLASS, and K5's int8 product
GEMM_KERNELS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def flop_floor(arch: str) -> dict:
    """Exact per-sample GEMM work (TFLOP) of the benched TTL step, and the
    time it implies at the H100's bf16 peak."""
    from ttl_tpu_torch.config import TTLConfig, resolve_layer_range
    from ttl_tpu_torch.models.zoo import get_arch

    clip_cfg = get_arch(arch)
    vc = clip_cfg.vision
    cfg = TTLConfig(arch=arch, resolution=vc.image_size)
    lo, hi = resolve_layer_range(cfg, clip_cfg)
    views = cfg.batch_size
    s_tok = vc.grid * vc.grid + 1
    d = vc.hidden
    per_layer_view = 24 * s_tok * d * d + 4 * s_tok * s_tok * d
    patchify = 2 * s_tok * (3 * vc.patch * vc.patch) * d
    n_window = hi - lo + 1
    prefix_f = views * lo * per_layer_view
    window_f = views * n_window * per_layer_view
    backward = 1.07 * window_f
    clean_pass = n_window * per_layer_view
    total = prefix_f + window_f + backward + views * patchify + clean_pass
    ms_at_peak = total / (H100_BF16_TFLOPS * 1e12) * 1e3
    return {
        "arch": arch, "layers": vc.layers, "hidden": d, "heads": vc.heads,
        "tokens": s_tok, "views": views, "window": [lo, hi],
        "prefix_tflop": round(prefix_f / 1e12, 3),
        "window_fwd_tflop": round(window_f / 1e12, 3),
        "backward_tflop": round(backward / 1e12, 3),
        "total_tflop_per_sample": round(total / 1e12, 3),
        "peak_tflops": H100_BF16_TFLOPS,
        "peak": "H100 SXM dense bf16, published, at 700 W",
        "ms_per_sample_at_peak": round(ms_at_peak, 4),
        "absolute_sps_ceiling": round(1e3 / ms_at_peak, 3),
    }


def busy_breakdown(step, device, steps: int = 4) -> dict | None:
    """Trace `step` and split the device time into GEMM kernels and the
    rest (softmax, attention, layernorm, elementwise, copies)."""
    from ttl_tpu_torch.utils.profiling import (device_busy_us, op_stats,
                                               trace)

    step(7).tolist()  # warm, outside the trace
    td = tempfile.mkdtemp(prefix="ttl_ceiling_trace_")
    try:
        with trace(td, device):
            for p in [step(10 + i) for i in range(steps)]:
                p.tolist()
        busy_us = device_busy_us(td)
        if not busy_us:
            return None
        rows = op_stats(td, top=1 << 20)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    gemm_us = sum(r["self_time_us"] for r in rows
                  if any(g in r["operation"].lower() for g in GEMM_KERNELS))
    return {
        "busy_ms_per_step": round(busy_us / steps / 1e3, 3),
        "gemm_ms_per_step": round(gemm_us / steps / 1e3, 3),
        "rest_ms_per_step": round((busy_us - gemm_us) / steps / 1e3, 3),
        "top_ops": [{"op": r["operation"][:72], "type": r["type"],
                     "ms_per_step": round(r["self_time_us"] / steps / 1e3,
                                          3)} for r in rows[:8]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ViT-L/14")
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--s_list", default="8")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--floor-only", action="store_true")
    ap.add_argument("--prefix_quant", default="none",
                    choices=["none", "int8"],
                    help="int8 frozen prefix (K5), the dominant GEMM block")
    args = ap.parse_args(argv)

    out = {"metric": f"{args.arch} ceiling accounting",
           "floor": flop_floor(args.arch), "rows": []}
    # the ViT-B/16 formula must reproduce the known accounting
    ref = flop_floor("ViT-B/16")
    if abs(ref["prefix_tflop"] - 1.68) >= 0.02:
        raise AssertionError(f"ViT-B/16 prefix {ref['prefix_tflop']} TFLOP, "
                             "expected 1.68")
    if not args.floor_only:
        import bench_torch
        from ttl_tpu_torch.ops.quant import (attach_prefix_quant,
                                             quant_prefix_len)
        from ttl_tpu_torch.runner import full_f32_products

        device = bench_torch.bench_device()
        full_f32_products(device)
        out["device"] = bench_torch.device_info(device, 1)
        for S in [int(s) for s in args.s_list.split(",") if s]:
            clip_cfg, cfg, params, adapters0, canv, hs, ws = \
                bench_torch.bench_inputs(args.arch, S, device)
            text_cls = bench_torch.classifier(params, clip_cfg, args.classes)
            if args.prefix_quant != "none":
                cfg = cfg.replace(prefix_quant=args.prefix_quant)
                params = attach_prefix_quant(
                    params, quant_prefix_len(cfg, clip_cfg))
            step, _ = bench_torch.make_step(clip_cfg, cfg, params, text_cls,
                                            adapters0, canv, hs, ws)
            wall = bench_torch.measure(clip_cfg, cfg, params, text_cls,
                                       adapters0, canv, hs, ws,
                                       windows=args.windows,
                                       iters=args.iters, step=step)
            row = {"s": S, "wall_sps": round(wall, 3)}
            bd = busy_breakdown(step, device) if device.type == "cuda" \
                else None
            if bd:
                row.update(bd)
                row["busy_sps"] = round(S / (bd["busy_ms_per_step"] / 1e3),
                                        3)
                floor_ms = out["floor"]["ms_per_sample_at_peak"] * S
                row["peak_share_of_gemm_time"] = round(
                    floor_ms / bd["gemm_ms_per_step"], 4)
                # practical ceiling: FLOPs at peak + the measured non-GEMM
                prac_ms = floor_ms + bd["rest_ms_per_step"]
                row["practical_sps_ceiling"] = round(S / (prac_ms / 1e3), 3)
                row["fraction_of_practical"] = round(
                    row["busy_sps"] / row["practical_sps_ceiling"], 4)
            out["rows"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
