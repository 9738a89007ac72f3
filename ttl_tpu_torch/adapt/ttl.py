"""The episodic adaptation steps, batched over test samples, and the
zero-shot step.

Counterpart of `make_ttl_adapt_fn`, `make_batched_ttl_fn`,
`make_fused_ttl_fn`, `make_tpt_adapt_fn`, `make_fused_tpt_fn`,
`make_fused_cocoop_fn` and `make_fused_zeroshot_fn` in
`ttl_tpu/adapt/ttl.py`. Where the JAX package
vmaps a per-sample program, the port batches: every trainable leaf carries
a leading sample axis S. For S samples of V views:

LoRA modes (`make_batched_ttl_fn`):
1. the frozen part runs once over all S*V views under `torch.no_grad()`:
   the vision prefix below the window (`--lora_encoder image`), or the whole
   vision tower (`--lora_encoder text`), whose features are then constant;
2. each update step runs the adapted part forward and backward with one
   adapter set per sample ([S, L, D, r] leaves): the vision window on the
   views, or the text tower over the EOT-truncated class prompts of every
   sample ([S*C, ctx', D]). The loss is DeYO's per sample, or with
   `deyo_selection=False` the TPT objective over the views chosen once, by
   the unadapted logits; AdamW applies elementwise over the stacked
   adapters; a sample whose DeYO loss kept no view (n_backward == 0) keeps
   its adapters and optimizer state, weight decay included;
3. the adapted part runs once more for each sample's clean view (view 0).

Prompt tuning (`make_tpt_adapt_fn`, `--lora_encoder prompt`): the image
features of all views are frozen; the context vectors (and the learned
class tokens, if any) are the trainable state, [S, n_ctx, d]; every step
differentiates the whole text tower, each layer checkpointed.

Every call starts from the same initial state and a fresh optimizer state:
that is the episodic reset. The number of updates is
`effective_update_steps` (tta_steps**2 on the DeYO path, tta_steps on the
TPT paths, as in the reference).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import TTLConfig, effective_update_steps, resolve_layer_range
from ..models.clip import (CLIPConfig, encode_image, l2_normalize,
                           text_features, text_features_from_embeddings,
                           vision_from_hidden, vision_prefix)
from ..models.prompts import PromptLearnerState, needed_ctx_len
from ..ops.entropy import deyo_loss, select_confident, tpt_loss
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
    zero_shot_logits: Optional[torch.Tensor] = None  # [S, C], prompt tuning


def compute_dtype(cfg: TTLConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg: TTLConfig) -> None:
    """Raise NotImplementedError for what this port does not cover yet,
    naming the ROADMAP (Queue 1) item that brings it."""
    unsupported = [
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


def _selection_k(cfg: TTLConfig) -> int:
    """Views the TPT objective keeps. The floor of 1 departs from the
    reference, whose int(N*p) == 0 selects nothing and gives a NaN loss."""
    return max(int(cfg.batch_size * cfg.selection_p), 1)


def _class_logits(params, img: torch.Tensor, txt: torch.Tensor,
                  n_samples: int) -> torch.Tensor:
    """exp(logit_scale) * img @ txt^T per sample: img [S*V, P] normalized
    image features, txt [S*C, P] text features (normalized here) ->
    [S, V, C]."""
    txt = l2_normalize(txt).unflatten(0, (n_samples, -1))
    img = (torch.exp(params["logit_scale"]) * img).unflatten(
        0, (n_samples, -1))
    return torch.matmul(img, txt.transpose(-1, -2))


def truncate_tokens(tokens) -> np.ndarray:
    """EOT-truncate a token table (exact; `needed_ctx_len`)."""
    tokens = np.asarray(tokens)
    return tokens[:, : needed_ctx_len(tokens)].astype(np.int64)


def make_batched_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig, *,
                        tokens=None):
    """Return f(params, text_cls [C, P], adapters0, views [S, V, 3, H, W])
    -> AdaptResult for S samples adapted independently. `tokens` [C, 77] is
    the class-prompt table, needed (and `text_cls` ignored) with
    `--lora_encoder text`."""
    check_supported(cfg)
    if cfg.lora_encoder == "prompt":
        raise ValueError("--lora_encoder prompt adapts no LoRA: use "
                         "make_tpt_adapt_fn")
    on_image = cfg.lora_encoder == "image"
    window = resolve_layer_range(cfg, clip_cfg)
    scale = lora_scale(cfg.rank, cfg.lora_alpha)
    cd = compute_dtype(cfg)
    steps = effective_update_steps(cfg)
    k_sel = _selection_k(cfg)
    vcfg = clip_cfg.vision
    if not on_image:
        if tokens is None:
            raise ValueError("--lora_encoder text needs the class-prompt "
                             "token table")
        tokens = torch.from_numpy(truncate_tokens(tokens))

    def logits_for(params, text_cls, leaves, frozen, n_samples):
        """[S, V', C] logits of the current adapters. `frozen` is the
        per-view state the adapters do not reach: the prefix hidden state
        [S*V', S_pad, D] (image mode), or the normalized image features
        [S*V', P] (text mode)."""
        if on_image:
            vf = vision_from_hidden(params["vision"], frozen, vcfg,
                                    adapters=_to_tree(leaves),
                                    adapter_window=window, lora_scale=scale)
            logits = (torch.exp(params["logit_scale"]) * l2_normalize(vf)
                      ) @ text_cls.T
            return logits.reshape(n_samples, -1, logits.shape[-1])
        txt = text_features(params["text"], tokens.to(frozen.device),
                            clip_cfg.text, adapters=_to_tree(leaves),
                            adapter_window=window, lora_scale=scale,
                            compute_dtype=cd)
        return _class_logits(params, frozen, txt, n_samples)

    def step(params, text_cls, adapters0, views) -> AdaptResult:
        s, v = views.shape[:2]
        with torch.no_grad():
            if on_image:
                frozen = vision_prefix(params["vision"], views.flatten(0, 1),
                                       vcfg, upto=window[0], compute_dtype=cd)
            else:
                frozen = l2_normalize(encode_image(
                    params["vision"], views.flatten(0, 1), vcfg,
                    compute_dtype=cd))
        leaves = [adapters0[m][ab].expand(s, *adapters0[m][ab].shape)
                  .clone() for m, ab in _LEAVES]
        every = torch.ones(s, dtype=torch.bool, device=views.device)
        sel_mask = None
        if not cfg.deyo_selection:
            # TPT on LoRA: the views are chosen once, by the unadapted logits
            with torch.no_grad():
                sel_mask = select_confident(
                    logits_for(params, text_cls, leaves, frozen, s), k_sel)[2]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        count = torch.zeros(s, dtype=torch.int32, device=views.device)
        losses = []
        for _ in range(steps):
            with torch.enable_grad():
                leaves = [t.requires_grad_(True) for t in leaves]
                logits = logits_for(params, text_cls, leaves, frozen, s)
                if cfg.deyo_selection:
                    loss, aux = deyo_loss(
                        logits, margin_e0=cfg.deyo_margin_e0,
                        deyo_margin=cfg.deyo_margin,
                        filter_ent=bool(cfg.filter_ent),
                        selection_p=cfg.selection_p,
                        reweight_ent=float(cfg.reweight_ent),
                        reweight_plpd=float(cfg.reweight_plpd))
                    do = aux["n_backward"] > 0
                else:
                    loss, do = tpt_loss(logits, sel_mask), every
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                leaves, mu, nu, count = _adamw(
                    [t.detach() for t in leaves], grads, mu, nu, count, do,
                    cfg.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            clean = frozen.unflatten(0, (s, v))[:, 0]
            out = logits_for(params, text_cls, leaves, clean, s)[:, 0]
        return AdaptResult(logits=out, losses=torch.stack(losses, dim=1),
                           adapters=_to_tree(leaves))

    return step


def make_fused_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig, *, tokens=None):
    """View rendering + the batched step: f(params, text_cls, adapters0,
    canvases [S, C, C, 3] uint8, hs [S], ws [S], draws) -> AdaptResult.
    `draws` are the host-made random draws (ops.image.draw_batch)."""
    batched = make_batched_ttl_fn(clip_cfg, cfg, tokens=tokens)
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


# ------------------------------------------------------------ prompt tuning

def make_tpt_adapt_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """TPT: tune the prompt learner's context vectors (and its learned class
    tokens, if it has them) instead of LoRA. Returns f(params, pl_state,
    views [S, V, 3, H, W]) -> (AdaptResult, adapted ctx [S, n_ctx, d]);
    `zero_shot_logits` are the unadapted clean-view logits."""
    check_supported(cfg)
    cd = compute_dtype(cfg)
    steps = cfg.tta_steps
    k_sel = _selection_k(cfg)

    def adapt(params, pl_state: PromptLearnerState, views):
        s = views.shape[0]
        with torch.no_grad():
            img = l2_normalize(encode_image(
                params["vision"], views.flatten(0, 1), clip_cfg.vision,
                compute_dtype=cd))
        learn_cls = pl_state.cls is not None

        def logits_for(leaves):
            embs = pl_state.assemble(leaves[0],
                                     leaves[1] if learn_cls else None)
            txt = text_features_from_embeddings(
                params["text"], embs.flatten(0, 1), pl_state.tokenized,
                clip_cfg.text, compute_dtype=cd, remat=True)
            return _class_logits(params, img, txt, s)

        init = [pl_state.ctx_init] + ([pl_state.cls_init] if learn_cls
                                      else [])
        leaves = [t.float().expand(s, *t.shape).clone() for t in init]
        # one unadapted forward gives the zero-shot logits and the selection
        with torch.no_grad():
            logits0 = logits_for(leaves)
            sel_mask = select_confident(logits0, k_sel)[2]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        count = torch.zeros(s, dtype=torch.int32, device=views.device)
        every = torch.ones(s, dtype=torch.bool, device=views.device)
        losses = []
        for _ in range(steps):
            with torch.enable_grad():
                leaves = [t.requires_grad_(True) for t in leaves]
                loss = tpt_loss(logits_for(leaves), sel_mask)
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                leaves, mu, nu, count = _adamw(
                    [t.detach() for t in leaves], grads, mu, nu, count,
                    every, cfg.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            out = logits_for(leaves)[:, 0]
        losses = (torch.stack(losses, dim=1) if losses
                  else torch.zeros(s, 0, device=views.device))
        return AdaptResult(logits=out, losses=losses, adapters={},
                           zero_shot_logits=logits0[:, 0]), leaves[0]

    return adapt


def make_fused_tpt_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """View rendering + prompt tuning: f(params, pl_state, canvases, hs, ws,
    draws) -> (AdaptResult, adapted ctx [S, n_ctx, d])."""
    adapt = make_tpt_adapt_fn(clip_cfg, cfg)
    cd = compute_dtype(cfg)

    def fused(params, pl_state, canvases, hs, ws, draws: Draws):
        with torch.no_grad():
            views = render_views(canvases, hs, ws, draws,
                                 out_size=cfg.resolution, out_dtype=cd)
        return adapt(params, pl_state, views)

    return fused


def make_fused_cocoop_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """View rendering + CoCoOp ctx adaptation (`--cocoop`): f(params,
    co_state, canvases, hs, ws, draws) -> CoCoOpResult with a leading
    sample axis."""
    from .cocoop import make_cocoop_adapt_fn
    check_supported(cfg)
    adapt = make_cocoop_adapt_fn(clip_cfg, cfg)
    cd = compute_dtype(cfg)

    def fused(params, co_state, canvases, hs, ws, draws: Draws):
        with torch.no_grad():
            views = render_views(canvases, hs, ws, draws,
                                 out_size=cfg.resolution, out_dtype=cd)
        return adapt(params, co_state, views)

    return fused
