"""The TTL episodic adaptation step, batched over test samples, and the
zero-shot step.

Counterpart of `make_ttl_adapt_fn` (image mode), `make_batched_ttl_fn`,
`make_fused_ttl_fn` and `make_fused_zeroshot_fn` in `ttl_tpu/adapt/ttl.py`.
For S samples of V views:

1. the frozen prefix runs once over all S*V views under `torch.no_grad()`;
2. each update step runs the LoRA window forward and backward with one
   adapter set per sample ([S, L, D, r] leaves), takes the DeYO loss per
   sample, and applies AdamW elementwise over the stacked adapters; a
   sample whose loss kept no view (n_backward == 0) keeps its adapters and
   optimizer state, weight decay included;
3. the adapted window runs once more on each sample's clean view (view 0).

Every call starts from the same `adapters0` and a fresh optimizer state:
that is the episodic reset. The number of updates is
`effective_update_steps` (tta_steps**2 on the DeYO path, as in the
reference).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ttl_tpu.config import (TTLConfig, effective_update_steps,
                            resolve_layer_range)

from ..models.clip import (CLIPConfig, encode_image, l2_normalize,
                           vision_from_hidden, vision_prefix)
from ..ops.entropy import deyo_loss
from ..ops.image import Draws, preprocess_center, render_views
from ..ops.lora import lora_scale

# torch.optim.AdamW defaults, as the reference and the JAX package use them
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-2


class AdaptResult(NamedTuple):
    logits: torch.Tensor     # [S, C] adapted clean-view logits
    losses: torch.Tensor     # [S, steps] adaptation losses
    adapters: dict           # final per-sample adapters, [S, L, ...] leaves


def compute_dtype(cfg: TTLConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg: TTLConfig) -> None:
    """Raise NotImplementedError for what this port does not cover yet,
    naming the ROADMAP (Queue 1) item that brings it."""
    unsupported = [
        (cfg.lora_encoder == "text", "--lora_encoder text", 9),
        (cfg.lora_encoder == "prompt", "--lora_encoder prompt (TPT)", 10),
        (not cfg.deyo_selection, "deyo_selection=False (TPT on LoRA)", 10),
        (cfg.cocoop, "--cocoop", 11),
        (bool(cfg.filter_plpd), "--filter_plpd", 13),
        (len(cfg.aug_ops) > 0, "--aug_list (AugMix)", 13),
        (cfg.checkpoint_path is not None, "--checkpoint_path", 14),
        (cfg.mesh_shape is not None, "--mesh_shape", 17),
    ]
    for hit, what, item in unsupported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to ttl_tpu_torch yet "
                f"(ROADMAP Queue 1, item {item})")


def _adamw(params, grads, mu, nu, count, do, lr):
    """One optax.adamw step over stacked per-sample leaves (leading axis S),
    applied where `do` [S] is set; returns (params, mu, nu, count)."""
    b1, b2 = ADAMW_BETAS
    count_new = count + 1
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        shape = (-1,) + (1,) * (p.dim() - 1)
        m_n = (1 - b1) * g + b1 * m
        v_n = (1 - b2) * g * g + b2 * v
        c = count_new.to(torch.float32).reshape(shape)
        m_hat = m_n / (1 - b1 ** c)
        v_hat = v_n / (1 - b2 ** c)
        u = m_hat / (torch.sqrt(v_hat) + ADAMW_EPS) + ADAMW_WEIGHT_DECAY * p
        d = do.reshape(shape)
        new_p.append(torch.where(d, p + (-lr) * u, p))
        new_mu.append(torch.where(d, m_n, m))
        new_nu.append(torch.where(d, v_n, v))
    return new_p, new_mu, new_nu, torch.where(do, count_new, count)


_LEAVES = (("q", "A"), ("q", "B"), ("v", "A"), ("v", "B"))


def _to_tree(leaves) -> dict:
    tree = {"q": {}, "v": {}}
    for (m, ab), t in zip(_LEAVES, leaves):
        tree[m][ab] = t
    return tree


def make_batched_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """Return f(params, text_cls [C, P], adapters0, views [S, V, 3, H, W])
    -> AdaptResult for S samples adapted independently."""
    check_supported(cfg)
    window = resolve_layer_range(cfg, clip_cfg)
    scale = lora_scale(cfg.rank, cfg.lora_alpha)
    cd = compute_dtype(cfg)
    steps = effective_update_steps(cfg)
    vcfg = clip_cfg.vision

    def logits_for(params, text_cls, leaves, hidden, n_samples):
        vf = vision_from_hidden(params["vision"], hidden, vcfg,
                                adapters=_to_tree(leaves),
                                adapter_window=window, lora_scale=scale)
        img = l2_normalize(vf)
        logits = (torch.exp(params["logit_scale"]) * img) @ text_cls.T
        return logits.reshape(n_samples, -1, logits.shape[-1])

    def step(params, text_cls, adapters0, views) -> AdaptResult:
        s, v = views.shape[:2]
        with torch.no_grad():
            hidden = vision_prefix(params["vision"], views.flatten(0, 1),
                                   vcfg, upto=window[0], compute_dtype=cd)
        leaves = [adapters0[m][ab].expand(s, *adapters0[m][ab].shape)
                  .clone() for m, ab in _LEAVES]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        count = torch.zeros(s, dtype=torch.int32, device=views.device)
        losses = []
        for _ in range(steps):
            with torch.enable_grad():
                leaves = [t.requires_grad_(True) for t in leaves]
                logits = logits_for(params, text_cls, leaves, hidden, s)
                loss, aux = deyo_loss(
                    logits, margin_e0=cfg.deyo_margin_e0,
                    deyo_margin=cfg.deyo_margin,
                    filter_ent=bool(cfg.filter_ent),
                    selection_p=cfg.selection_p,
                    reweight_ent=float(cfg.reweight_ent),
                    reweight_plpd=float(cfg.reweight_plpd))
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                leaves, mu, nu, count = _adamw(
                    [t.detach() for t in leaves], grads, mu, nu, count,
                    aux["n_backward"] > 0, cfg.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            clean = hidden.unflatten(0, (s, v))[:, 0]
            out = logits_for(params, text_cls, leaves, clean, s)[:, 0]
        return AdaptResult(logits=out, losses=torch.stack(losses, dim=1),
                           adapters=_to_tree(leaves))

    return step


def make_fused_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """View rendering + the batched step: f(params, text_cls, adapters0,
    canvases [S, C, C, 3] uint8, hs [S], ws [S], draws) -> AdaptResult.
    `draws` are the host-made random draws (ops.image.draw_batch)."""
    batched = make_batched_ttl_fn(clip_cfg, cfg)
    cd = compute_dtype(cfg)

    def fused(params, text_cls, adapters0, canvases, hs, ws,
              draws: Draws) -> AdaptResult:
        with torch.no_grad():
            views = render_views(canvases, hs, ws, draws,
                                 out_size=cfg.resolution, out_dtype=cd)
        return batched(params, text_cls, adapters0, views)

    return fused


def make_fused_zeroshot_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """Center view + zero-shot classification (tta_steps 0):
    f(params, text_cls [C, P], canvases [S, C, C, 3] uint8, hs [S], ws [S])
    -> logits [S, C]. It consumes no randomness."""
    cd = compute_dtype(cfg)

    @torch.no_grad()
    def zeroshot(params, text_cls, canvases, hs, ws) -> torch.Tensor:
        views = preprocess_center(canvases, hs, ws, cfg.resolution,
                                  out_dtype=cd)
        vf = l2_normalize(encode_image(params["vision"], views,
                                       clip_cfg.vision, compute_dtype=cd))
        return torch.exp(params["logit_scale"]) * vf @ text_cls.T

    return zeroshot
