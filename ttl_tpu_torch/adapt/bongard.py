"""Bongard-HOI episodic evaluation.

Counterpart of `ttl_tpu/adapt/bongard.py`. Per episode (6 positive + 6
negative support images, 1 query per polarity): encode the support images'
center views with the frozen vision tower, build the two class prototypes as
the L2-normalized mean support feature of each polarity, then classify each
query against that [2, P] table - at `--tta_steps 0` from its center view,
else through the full episodic TTL step (64 views, LoRA on the vision
window, the DeYO objective over the 2-way logits), the prototype table
taking the place of the text classifier. Every query starts from the same
fresh adapter state.

The queries of an episode go through one batched step. Each carries its own
episode's table, [S, 2, P] (`make_batched_ttl_fn` takes a classifier per
sample), where the JAX package vmaps a single-query program over the
tables; the view draws of query q of episode e are those of dataset index
e * n_queries + q, as JAX keys them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TTLConfig
from ..data.views import load_canvas
from ..models.clip import l2_normalize
from ..utils.meters import AverageMeter, Summary
from .ttl import make_center_encoder as make_support_encoder
from .ttl import make_fused_ttl_fn as make_bongard_step_fn

__all__ = ["make_bongard_step_fn", "make_support_encoder",
           "evaluate_bongard"]

CANVAS = 512


def evaluate_bongard(cfg: TTLConfig, dataset, clip_cfg, params, adapters0,
                     *, device, max_episodes: Optional[int] = None) -> float:
    """Episode accuracy (%) over a BongardDataset: `dataset[i]` yields a
    `data.bongard.BongardEpisode`."""
    from ..runner import sample_draws

    if cfg.tta_steps > 0 and cfg.lora_encoder != "image":
        raise ValueError(
            "bongard episodic adaptation tunes vision-encoder LoRA against "
            "the support-prototype classifier; lora_encoder="
            f"{cfg.lora_encoder!r} has no text/prompt tower to adapt here. "
            "Use --lora_encoder image, or --tta_steps 0 for the pure "
            "prototype evaluation.")
    device = torch.device(device)
    encode = make_support_encoder(clip_cfg, cfg)
    adapt = (make_bongard_step_fn(clip_cfg, cfg) if cfg.tta_steps > 0
             else None)
    acc = AverageMeter("Acc@1", ":6.2f", Summary.AVERAGE)

    n_ep = len(dataset) if max_episodes is None else min(len(dataset),
                                                         max_episodes)
    for ei in range(n_ep):
        ep = dataset[ei]
        paths = list(ep.support_paths) + list(ep.query_paths)
        canv = np.zeros((len(paths), CANVAS, CANVAS, 3), np.uint8)
        hs = np.zeros((len(paths),), np.int32)
        ws = np.zeros((len(paths),), np.int32)
        for k, p in enumerate(paths):
            canv[k], hs[k], ws[k] = load_canvas(p, CANVAS)
        canv, hs, ws = (torch.from_numpy(x).to(device) for x in (canv, hs,
                                                                ws))

        n_sup = len(ep.support_paths)
        feats = encode(params, canv[:n_sup], hs[:n_sup], ws[:n_sup])
        labels = np.asarray(ep.support_labels)
        protos = torch.stack([  # [2, P], class order = label value
            l2_normalize(feats[torch.from_numpy(
                np.flatnonzero(labels == c)).to(device)].mean(dim=0))
            for c in (0, 1)])

        nq = len(ep.query_paths)
        if adapt is None:
            qf = encode(params, canv[n_sup:], hs[n_sup:], ws[n_sup:])
            logits = torch.exp(params["logit_scale"]) * qf @ protos.T
        else:
            draws = sample_draws(cfg, np.arange(nq) + ei * nq)
            logits = adapt(params, protos.expand(nq, *protos.shape),
                           adapters0, canv[n_sup:], hs[n_sup:], ws[n_sup:],
                           {k: t.to(device) for k, t in draws.items()}
                           ).logits
        pred = logits.argmax(dim=-1).cpu().numpy()
        correct = (pred == np.asarray(ep.query_labels)).mean()
        acc.update(100.0 * float(correct), nq)
    return acc.avg
