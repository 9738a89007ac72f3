#!/usr/bin/env python
"""The int8 frozen prefix against full precision, on the PyTorch port.

The counterpart of tools/quant_fidelity.py: at an arch's published widths
and random weights (seed 0), over a sweep of random canvases, the fused TTL
step (64-view generation -> episodic adaptation -> adapted clean-view
logits) runs twice from identical inputs, full precision and with the int8
prefix (`--prefix_quant int8`, K5 on the card), and one JSON line reports

  * top-1 flip rate between the two adapted predictions,
  * top-5 set-overlap,
  * logit deviation stats (max / mean abs, on the adapted logits).

Usage (on the card; --cpu runs the kernels' plain versions, tiny sweeps
only):
  python tools/torch_quant_fidelity.py --samples 256 --classes 200
  python tools/torch_quant_fidelity.py --cpu --arch test-tiny --samples 4
"""
import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--sample_batch", type=int, default=8)
    ap.add_argument("--arch", default="ViT-B/16")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (tiny sweeps only)")
    args = ap.parse_args(argv)

    import torch

    from ttl_tpu_torch.adapt.ttl import make_fused_ttl_fn
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.models.clip import init_clip_params
    from ttl_tpu_torch.models.prompts import (build_text_classifier,
                                              prompt_tokens)
    from ttl_tpu_torch.models.zoo import get_arch
    from ttl_tpu_torch.ops.quant import attach_prefix_quant, quant_prefix_len
    from ttl_tpu_torch.runner import (full_f32_products, make_adapters0,
                                      sample_draws)

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    else:
        raise RuntimeError("ttl_tpu_torch needs a CUDA device; none is "
                           "available (--cpu runs on the CPU)")
    full_f32_products(device)
    s = args.sample_batch
    clip_cfg = get_arch(args.arch)
    # resolution must follow the arch (ViT-L/14@336px patchifies at 336)
    tiny = args.arch == "test-tiny"
    cfg = TTLConfig(arch=args.arch, sample_batch=s,
                    resolution=clip_cfg.vision.image_size,
                    **(dict(layer_range=(2, 3), rank=4) if tiny else {}))
    params = init_clip_params(clip_cfg, torch.Generator().manual_seed(0),
                              device=device, param_dtype=torch.bfloat16)
    names = resolve_classnames("I")[: args.classes]
    text_cls = build_text_classifier(params["text"], prompt_tokens(names),
                                     clip_cfg.text, device=device)
    adapters0 = make_adapters0(cfg, clip_cfg, device)
    qcfg = cfg.replace(prefix_quant="int8")
    qparams = attach_prefix_quant(params, quant_prefix_len(qcfg, clip_cfg))
    fn_f = make_fused_ttl_fn(clip_cfg, cfg)
    fn_q = make_fused_ttl_fn(clip_cfg, qcfg)

    flips = top5_overlap = n_logits = n_done = 0
    max_dev = sum_dev = 0.0
    rng = np.random.RandomState(0)
    canvas = 128 if tiny else 512
    while n_done < args.samples:
        canv = (rng.rand(s, canvas, canvas, 3) * 255).astype(np.uint8)
        hs = rng.randint(canvas * 2 // 5, canvas, (s,)).astype(np.int32)
        ws = rng.randint(canvas * 2 // 5, canvas, (s,)).astype(np.int32)
        draws = {k: t.to(device) for k, t in sample_draws(
            cfg, np.arange(s) + n_done).items()}
        put = [torch.from_numpy(a).to(device) for a in (canv, hs, ws)]
        lf = fn_f(params, text_cls, adapters0, *put, draws).logits
        lq = fn_q(qparams, text_cls, adapters0, *put, draws).logits
        lf, lq = (x.float().cpu().numpy() for x in (lf, lq))
        flips += int(np.sum(lf.argmax(-1) != lq.argmax(-1)))
        for a, b in zip(lf, lq):
            top5_overlap += len(set(np.argsort(-a)[:5].tolist())
                                & set(np.argsort(-b)[:5].tolist()))
        dev = np.abs(lf - lq)
        max_dev = max(max_dev, float(dev.max()))
        sum_dev += float(dev.sum())
        n_logits += dev.size
        n_done += s

    out = {
        "metric": "int8-prefix vs full-precision adapted predictions "
                  f"({args.arch}, random weights, {len(names)} classes)",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "samples": n_done,
        "top1_flip_rate": round(flips / n_done, 4),
        "top5_overlap_of_5": round(top5_overlap / n_done, 3),
        "logit_max_abs_dev": round(max_dev, 4),
        "logit_mean_abs_dev": round(sum_dev / n_logits, 5),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
