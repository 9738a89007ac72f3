"""CoCoOp: image-conditioned prompt generation and test-time ctx tuning.

Counterpart of `ttl_tpu/adapt/cocoop.py` (the reference's clip/cocoop.py
and ttl.py:71-74, 92-93): a meta-net (Linear -> ReLU -> Linear) maps an
image feature to a shift of the CoOp ctx vectors; at test time the shifted
ctx (`pgen_ctx`) is tuned with the TPT selection + average-entropy
objective.

Faithfulness note: in the reference the adapted pgen_ctx is a local tensor
that the final inference call never reads: `model(image)` runs plain CoCoOp
inference with the unadapted meta-net ctx. `logits` reproduces exactly
that; `adapted_logits` are the clean view's logits under the ctx the
adaptation produced, for users who want them.

Where the JAX package vmaps a per-sample program, the port batches: views
[S, V, 3, H, W], ctx [S, n_ctx, d], the text tower over [S*C, ctx', d],
sample-major. The vision tower is frozen over all its layers for every
view, so it runs once under `torch.no_grad()` with `fused_ln=True`: on the
card its layernorm + linear pairs are K6 (`ops/ln_matmul.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import TTLConfig
from ..models.clip import (CLIPConfig, encode_image, l2_normalize,
                           text_features_from_embeddings)
from ..models.prompts import needed_ctx_len, prompt_tokens
from ..ops.entropy import select_confident, tpt_loss
from ..tokenizer.bpe import default_tokenizer
from .ttl import _adamw, _class_logits, _selection_k, compute_dtype


@dataclasses.dataclass
class CoCoOpState:
    """Prompt-generator state (CoCoOpPromptLearner buffers + meta-net)."""
    ctx: torch.Tensor        # [n_ctx, d] base ctx vectors
    meta_w1: torch.Tensor    # [proj_dim, proj_dim // 16]
    meta_b1: torch.Tensor
    meta_w2: torch.Tensor    # [proj_dim // 16, d]
    meta_b2: torch.Tensor
    prefix: torch.Tensor     # [C, 1, d]
    suffix: torch.Tensor     # [C, L - 1 - n_ctx, d]
    tokenized: torch.Tensor  # [C, L] int64 (L <= 77, EOT-truncated)
    n_ctx: int


def init_cocoop(token_embed: torch.Tensor, classnames: Sequence[str],
                proj_dim: int, generator: torch.Generator,
                ctx_init: str = "a_photo_of_a") -> CoCoOpState:
    """The state for a set's classes from the frozen token embedding table
    (on its device), in f32. The meta-net is drawn on the host from
    `generator` as torch's Linear default, U(+-1/sqrt(fan_in)), the biases
    with their weight's fan-in; a trained CoCoOp checkpoint overwrites it
    (`utils.checkpoint.apply_cocoop_ckpt`). Prompt padding past the longest
    EOT is dropped (needed_ctx_len; exact): the text tower re-encodes these
    prompts at every adaptation step."""
    tk = default_tokenizer()
    phrase = ctx_init.replace("_", " ")
    n_ctx = len(phrase.split(" "))
    device = token_embed.device
    toks = prompt_tokens(classnames, phrase)
    toks = torch.from_numpy(
        toks[:, : needed_ctx_len(toks)].astype(np.int64)).to(device)
    embedding = token_embed[toks].float()
    d = token_embed.shape[-1]
    hidden = proj_dim // 16

    def unif(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return ((torch.rand(shape, generator=generator) * 2 - 1) * bound
                ).to(device)

    ids = torch.tensor(tk.encode(phrase), device=device)
    return CoCoOpState(
        ctx=token_embed[ids].float(),
        meta_w1=unif((proj_dim, hidden), proj_dim),
        meta_b1=unif((hidden,), proj_dim),
        meta_w2=unif((hidden, d), hidden),
        meta_b2=unif((d,), hidden),
        prefix=embedding[:, :1],
        suffix=embedding[:, 1 + n_ctx:],
        tokenized=toks,
        n_ctx=n_ctx)


def meta_shift(state: CoCoOpState, image_features: torch.Tensor
               ) -> torch.Tensor:
    """ctx + meta_net(image feature): [..., proj_dim] -> [..., n_ctx, d]."""
    h = torch.relu(image_features @ state.meta_w1 + state.meta_b1)
    bias = h @ state.meta_w2 + state.meta_b2
    return state.ctx + bias.unsqueeze(-2)


class CoCoOpResult(NamedTuple):
    logits: torch.Tensor          # [S, C] reference-faithful: UNadapted ctx
    adapted_logits: torch.Tensor  # [S, C] clean view under the adapted ctx
    losses: torch.Tensor          # [S, tta_steps]


def make_cocoop_adapt_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """f(params, state, views [S, V, 3, H, W]) -> CoCoOpResult.

    gen_ctx: the mean of a sample's normalised view features -> shifted ctx
    (pgen_ctx); adapt: `cfg.tta_steps` AdamW steps on pgen_ctx with the TPT
    objective, the confident views chosen once, on the forward at the
    initial pgen_ctx; inference: the clean view's prompts from the unadapted
    meta-net. The text tower runs under checkpoints: it is differentiated
    with respect to pgen_ctx at every step."""
    cd = compute_dtype(cfg)
    k_sel = _selection_k(cfg)

    def adapt_and_infer(params, state: CoCoOpState, views) -> CoCoOpResult:
        s = views.shape[0]
        with torch.no_grad():
            vf = l2_normalize(encode_image(
                params["vision"], views.flatten(0, 1), clip_cfg.vision,
                compute_dtype=cd, fused_ln=True))            # [S*V, P]
            per_sample = vf.unflatten(0, (s, -1))
            pgen_ctx0 = meta_shift(state, per_sample.mean(dim=1))
            clean = per_sample[:, 0]                         # [S, P]

        def logits_for(ctx, img):
            """ctx [S, n_ctx, d], img [S*V', P] -> [S, V', C]."""
            n_cls = state.prefix.shape[0]
            block = ctx.unsqueeze(1).expand(s, n_cls, *ctx.shape[1:])
            embs = torch.cat([state.prefix.expand(s, *state.prefix.shape),
                              block,
                              state.suffix.expand(s, *state.suffix.shape)],
                             dim=2)
            txt = text_features_from_embeddings(
                params["text"], embs.flatten(0, 1), state.tokenized,
                clip_cfg.text, compute_dtype=cd, remat=True)
            return _class_logits(params, img, txt, s)

        with torch.no_grad():
            sel_mask = select_confident(logits_for(pgen_ctx0, vf), k_sel)[2]
        ctx = pgen_ctx0.clone()
        mu, nu = [torch.zeros_like(ctx)], [torch.zeros_like(ctx)]
        count = torch.zeros(s, dtype=torch.int32, device=views.device)
        every = torch.ones(s, dtype=torch.bool, device=views.device)
        losses = []
        for _ in range(cfg.tta_steps):
            with torch.enable_grad():
                ctx = ctx.requires_grad_(True)
                loss = tpt_loss(logits_for(ctx, vf), sel_mask)
                grads = torch.autograd.grad(loss.sum(), [ctx])
            with torch.no_grad():
                (ctx,), mu, nu, count = _adamw(
                    [ctx.detach()], grads, mu, nu, count, every, cfg.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            ref_logits = logits_for(meta_shift(state, clean), clean)[:, 0]
            adapted_logits = logits_for(ctx, clean)[:, 0]
        losses = (torch.stack(losses, dim=1) if losses
                  else torch.zeros(s, 0, device=views.device))
        return CoCoOpResult(logits=ref_logits, adapted_logits=adapted_logits,
                            losses=losses)

    return adapt_and_infer
