"""Toy end-to-end TTL demo on the PyTorch port: train a tiny CLIP vision
tower, shift the test distribution, and watch the episodic adaptation
mechanics.

The counterpart of examples/toy_ttl_demo.py. No checkpoints or datasets
needed; on the card unless --cpu is given (about a minute on the CPU):

    python tools/torch_toy_ttl_demo.py [--cpu] [--train_steps 300]

What it shows:
- the full pipeline (training -> anchor classifier -> canvas -> device views
  -> episodic TTL step) wired end to end;
- confidence maximization doing what it says: the mean max-probability of
  the adapted logits against the zero-shot ones (`zero_shot_logits`, the
  step's aux pass), after one AdamW step on the LoRA adapters;
- an honest caveat: on a 4-class toy under extreme synthetic noise,
  committing confidently can hurt top-1; the paper's OOD gains rely on
  real CLIP feature geometry and 200-1000 class structure. This demo
  validates the machinery, not the research claim.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

COLORS = torch.tensor([[1, .1, .1], [.1, 1, .1], [.1, .1, 1], [1, 1, .1]])
CLASSES = ["red", "green", "blue", "yellow"]


def make_batch(labels: torch.Tensor, gen: torch.Generator,
               noise: float = 0.05) -> torch.Tensor:
    """Flat-colour 64 x 64 images [N, 3, 64, 64] in [0, 1], with noise."""
    img = COLORS[labels][:, :, None, None] * torch.ones(3, 64, 64) \
        + noise * torch.randn(len(labels), 3, 64, 64, generator=gen)
    return img.clamp(0, 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--train_steps", type=int, default=300)
    args = ap.parse_args(argv)

    from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.models.clip import (init_clip_params, l2_normalize,
                                           vision_features)
    from ttl_tpu_torch.models.zoo import TEST_TINY
    from ttl_tpu_torch.ops.image import draw_batch, normalize, render_views
    from ttl_tpu_torch.ops.lora import init_adapters
    from ttl_tpu_torch.runner import full_f32_products

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    else:
        raise RuntimeError("ttl_tpu_torch needs a CUDA device; none is "
                           "available (--cpu runs on the CPU)")
    full_f32_products(device)
    v = TEST_TINY.vision
    params = init_clip_params(TEST_TINY, torch.Generator().manual_seed(0),
                              device=device)
    # stands in for the text classifier
    anchors = torch.eye(4, v.proj_dim, device=device)
    params["logit_scale"] = torch.tensor(math.log(10.0), device=device)

    leaves = []

    def trainable(node):
        if isinstance(node, dict):
            return {k: trainable(t) for k, t in node.items()}
        leaves.append(node.requires_grad_(True))
        return node

    vp = trainable(params["vision"])
    opt = torch.optim.Adam(leaves, lr=2e-3)
    gen = torch.Generator().manual_seed(42)
    print(f"training tiny CLIP vision tower ({args.train_steps} steps, "
          f"{device.type})...")
    for _ in range(args.train_steps):
        labels = torch.randint(0, 4, (16,), generator=gen)
        imgs = normalize(make_batch(labels, gen)).to(device)
        vf = l2_normalize(vision_features(vp, imgs, v,
                                          compute_dtype=torch.float32))
        logits = torch.exp(params["logit_scale"]) * vf @ anchors.T
        loss = torch.nn.functional.cross_entropy(logits, labels.to(device))
        opt.zero_grad()
        loss.backward()
        opt.step()
    params["vision"] = {k: v_ for k, v_ in vp.items()}
    for t in leaves:
        t.requires_grad_(False)

    labels = torch.arange(4).repeat(8)
    clean = make_batch(labels, torch.Generator().manual_seed(8))
    shift = (0.15 * clean + 0.4 + 0.55 * torch.randn(
        clean.shape, generator=torch.Generator().manual_seed(77))).clamp(0, 1)

    cfg = TTLConfig(batch_size=16, layer_range=(2, 3), rank=4,
                    compute_dtype="float32", param_dtype="float32",
                    resolution=64)
    adapt = make_batched_ttl_fn(TEST_TINY, cfg, zero_shot_aux=True)
    adapters0 = init_adapters(torch.Generator().manual_seed(1), 2, v.hidden,
                              cfg.rank, "xavier", device=device)
    canv = np.zeros((32, 128, 128, 3), np.uint8)
    canv[:, :64, :64] = (shift.permute(0, 2, 3, 1).numpy() * 255).astype(
        np.uint8)
    hs = ws = torch.full((32,), 64, dtype=torch.int32, device=device)
    draws = {k: t.to(device) for k, t in
             draw_batch(cfg.seed, range(32), cfg.batch_size).items()}
    with torch.no_grad():
        views = render_views(torch.from_numpy(canv).to(device), hs, ws, draws,
                             out_size=64, out_dtype=torch.float32)
    res = adapt(params, anchors, adapters0, views)

    def stats(logits):
        logits = logits.float().cpu()
        acc = float((logits.argmax(-1) == labels).float().mean())
        conf = float(torch.softmax(logits, -1).max(-1).values.mean())
        return acc, conf

    zs_acc, zs_conf = stats(res.zero_shot_logits)
    ad_acc, ad_conf = stats(res.logits)
    print("shifted test set (32 samples, 4 classes):")
    print(f"  zero-shot : top-1 {zs_acc:.3f}  mean confidence {zs_conf:.3f}")
    print(f"  TTL       : top-1 {ad_acc:.3f}  mean confidence {ad_conf:.3f}")
    print("(confidence maximization is the mechanism; accuracy gains need "
          "real CLIP geometry - see BASELINE.md)")
    return {"zero_shot": (zs_acc, zs_conf), "ttl": (ad_acc, ad_conf)}


if __name__ == "__main__":
    main()
