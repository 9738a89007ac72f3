"""Batch offline prediction: adapt-and-classify a directory of images.

Counterpart of `ttl_tpu/predict.py`. The runner evaluates *labeled*
datasets; this is the label-free product surface: walk a directory, run
every image through the full episodic TTL step at pipeline speed, and write
one JSON line per image with the adapted top-k labels, their probabilities,
and the zero-shot label.

    python -m ttl_tpu_torch.predict IMAGES_DIR --test_sets I \\
        --checkpoint_path clip.npz --out predictions.jsonl [--gpu 0]

The command runs on a CUDA card; `predict_directory(..., device="cpu")`
runs the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np
import torch

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
# steps dispatched before the oldest one's results are read
IN_FLIGHT = 2


class ImageDirDataset:
    """All images under a directory (recursive, sorted), labels unused."""

    def __init__(self, root: str):
        self.paths: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.lower().endswith(IMAGE_EXTS):
                    self.paths.append(os.path.join(dirpath, f))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root!r} "
                                    f"(looked for {', '.join(IMAGE_EXTS)})")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        return self.paths[i], 0


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Row softmax in f32 numpy, as the JAX package's surfaces compute it."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return probs / probs.sum(-1, keepdims=True)


def predict_directory(cfg, classnames, *, device, dataset=None,
                      topk: int = 5, out=sys.stdout) -> int:
    """Stream `cfg.data` (or `dataset`) through the fused TTL step on
    `device` and write one JSON line per image to `out`. Returns the number
    of images."""
    from .adapt.ttl import (compute_dtype, make_fused_ttl_fn,
                            make_fused_zeroshot_fn)
    from .data.views import DEFAULT_CANVAS, SampleLoader
    from .models.clip import VisionConfig
    from .models.prompts import build_text_classifier, prompt_tokens
    from .models.zoo import get_arch
    from .runner import (_make_upload, full_f32_products, load_model,
                         make_adapters0, on_current_stream)

    device = torch.device(device)
    if cfg.tta_steps > 0 and cfg.lora_encoder == "prompt":
        raise ValueError(
            "batch prediction serves the LoRA modes (lora_encoder="
            "'image'|'text'); for TPT prompt adaptation use the CLI runner")
    if cfg.tta_steps > 0 and cfg.lora_encoder == "image" \
            and not isinstance(get_arch(cfg.arch).vision, VisionConfig):
        raise ValueError(
            f"arch {cfg.arch!r} has a ResNet vision tower; image-encoder "
            "LoRA adaptation requires a ViT backbone. Use "
            "--lora_encoder text or --tta_steps 0.")
    full_f32_products(device)
    clip_cfg, params = load_model(cfg, device)
    toks = prompt_tokens(classnames, cfg.ctx_init.replace("_", " "))
    text_mode = cfg.tta_steps > 0 and cfg.lora_encoder == "text"
    # text mode encodes the class prompts at every step, from their tokens
    text_cls = None if text_mode else build_text_classifier(
        params["text"], toks, clip_cfg.text, device=device,
        compute_dtype=compute_dtype(cfg))
    if cfg.tta_steps > 0:
        adapters0 = make_adapters0(cfg, clip_cfg, device)
        # the output reports the pre-adaptation label too, so this surface
        # opts into the zero-shot aux pass (the eval runner leaves it off)
        step_fn = make_fused_ttl_fn(clip_cfg, cfg,
                                    tokens=toks if text_mode else None,
                                    zero_shot_aux=True)

        def run_step(b):
            res = step_fn(params, text_cls, adapters0, b.canvases, b.hs,
                          b.ws, b.draws)
            return res.logits, res.zero_shot_logits
    else:
        zs_fn = make_fused_zeroshot_fn(clip_cfg, cfg)

        def run_step(b):
            logits = zs_fn(params, text_cls, b.canvases, b.hs, b.ws)
            return logits, logits

    ds = dataset if dataset is not None else ImageDirDataset(cfg.data)
    # --canvas: an explicit size wins, a dataset that declares
    # max_image_dim shrinks the upload, as in the eval loop
    canvas = cfg.canvas if cfg.canvas > 0 else \
        (getattr(ds, "max_image_dim", None) or DEFAULT_CANVAS)
    upload = _make_upload(cfg, device, cfg.sample_batch)
    loader = SampleLoader(ds, batch_size=cfg.sample_batch, shuffle=False,
                          workers=cfg.workers, canvas=canvas,
                          transform=lambda b: (b, upload(b)))
    paths = getattr(ds, "paths", None)  # avoid re-decoding via ds[i]
    n_written = 0

    def drain(batch, pending):
        nonlocal n_written
        logits, zs = (x.float().cpu().numpy() for x in pending)
        probs = softmax_np(logits[:logits.shape[0] - batch.pad])
        for row, (p, z) in enumerate(zip(probs, zs)):
            order = np.argsort(-p)[:topk]
            idx = int(batch.indices[row])
            out.write(json.dumps({
                "path": paths[idx] if paths is not None else idx,
                "label": classnames[int(order[0])],
                "topk": [{"label": classnames[int(i)],
                          "prob": round(float(p[i]), 6)} for i in order],
                "zero_shot_label": classnames[int(np.argmax(z))],
            }) + "\n")
            n_written += 1

    in_flight = []
    for batch, moved in loader:
        in_flight.append((batch, run_step(on_current_stream(moved,
                                                            device))))
        if len(in_flight) > IN_FLIGHT:
            drain(*in_flight.pop(0))
    for item in in_flight:
        drain(*item)
    out.flush()
    return n_written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TTL batch prediction")
    p.add_argument("data", metavar="IMAGES_DIR")
    p.add_argument("--test_sets", default="I",
                   help="set_id whose classname table to predict over")
    p.add_argument("--classnames", default=None,
                   help="JSON file with a classname list (overrides "
                        "--test_sets)")
    p.add_argument("--arch", default="ViT-B/16")
    p.add_argument("--resolution", default=224, type=int)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--tta_steps", default=1, type=int)
    p.add_argument("--lora_encoder", default="image",
                   choices=["image", "text"])
    p.add_argument("--sample_batch", default=8, type=int)
    p.add_argument("--prefix_quant", default="none",
                   choices=["none", "int8"],
                   help="int8-quantize the frozen vision prefix "
                        "(throughput over exact parity)")
    p.add_argument("--canvas", default=0, type=int,
                   help="host->device canvas edge in px (0 = 512); set to "
                        "the directory's max image dim to cut upload "
                        "bandwidth - larger images are downscaled to fit")
    p.add_argument("--topk", default=5, type=int)
    p.add_argument("--out", default=None, help="output JSONL (default "
                                               "stdout)")
    p.add_argument("--gpu", default=0, type=int,
                   help="index of the CUDA card to run on")
    return p


def main(argv=None):
    from .config import TTLConfig
    from .data.classnames import resolve_classnames

    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ttl_tpu_torch needs a CUDA device; none is "
                           "available")
    cfg = TTLConfig(data=args.data, arch=args.arch,
                    resolution=args.resolution,
                    checkpoint_path=args.checkpoint_path,
                    tta_steps=args.tta_steps,
                    lora_encoder=args.lora_encoder,
                    sample_batch=args.sample_batch, canvas=args.canvas,
                    prefix_quant=args.prefix_quant, gpu=args.gpu)
    if args.classnames:
        with open(args.classnames) as f:
            classnames = json.load(f)
    else:
        classnames = resolve_classnames(args.test_sets)
    sink = open(args.out, "w") if args.out else sys.stdout
    try:
        n = predict_directory(cfg, classnames,
                              device=torch.device(f"cuda:{args.gpu}"),
                              topk=args.topk, out=sink)
    finally:
        if args.out:
            sink.close()
    print(f"wrote {n} predictions", file=sys.stderr)


if __name__ == "__main__":
    main()
