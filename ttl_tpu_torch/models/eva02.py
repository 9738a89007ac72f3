"""EVA02-CLIP's vision tower as plain functions over parameter dictionaries.

EVA-CLIP (arXiv:2303.15389), `eva_vit_model.py`: `Block` with
`Attention(subln=True)`, its rotary embedding and `SwiGLU(subln=True)`, as
EVA02-CLIP-L/14@336 configures them. A view enters as
x0 = [cls ; patches W_patch + b_patch] + pos (no ln_pre); each layer is

    h = LN1(x);   [q | k | v] = h [Wq | Wk | Wv] + [bq | 0 | bv]  (no k bias)
    q, k <- RoPE(q), RoPE(k) on the patch tokens        (`ops/rope.py`)
    x = x + LN_attn(softmax(q k^T / sqrt(d)) v) Wo + bo
    h = LN2(x);   [u | g] = h [W1 | W2] + [b1 | b2]
    x = x + LN_ffn(SiLU(u) * g) W3 + b3                 (`ops/swiglu.py`)

with no layer scale and no drop path, and the features are
LN_post(x)[:, 0] W_head + b_head, in f32. Every layernorm has the config's
`ln_eps` (1e-6); LN_ffn's statistics are over the true hidden width
`mlp_hidden` (2730 at L/14), which nothing pads.

Layout: a layer stores the fused `qkv` ([D, 3D], its bias [3D] zero in k's
third) and `w12` ([D, 2F]: W1's columns, then W2's), `o`, `w3` and the four
layernorms `ln1`, `ln_attn`, `ln2`, `ln_ffn`; layers are stacked on a
leading axis as in `models/clip.py`.

Numerics are the CLIP towers' (`models/clip.py`): products in the compute
dtype with the bias added in that dtype (`linear`), layernorm statistics in
f32, attention through `ops.attention.attention` with the tokens padded once
a forward on the bshd route (577 -> 592 at L/14@336), LoRA on q and v by
`_lora_delta` (q's delta added before RoPE), the patch embedding and the
head in f32. RoPE runs under the span `eva.rope`, q and k of a layer in one.

Wherever no gradient can reach the prefix (`vision_prefix`), LN1 -> qkv and
LN_attn -> o each run as one `ln_matmul` call with the "linear" epilogue
(K6 on the card, K = 1024, N = 3072 and 1024); LN2 -> w12 is `layer_norm`
and one product, then the SwiGLU kernel; LN_ffn and w3 stay `layer_norm`
and `linear` (K6 takes K and N in multiples of 16 and holds its K-wide row
tile in shared memory; 2730 is neither). On the card each `layer_norm` is
the layernorm kernel (`ops/layer_norm.py`). The adapted window, the clean-view passes and any
layer a gradient reaches run the same layer unfolded, which on the CPU is
the folded one bit for bit. The adapted layers are recomputed in the
backward (`vision_from_hidden`), so a step runs their forward twice.

Not supported on this tower, each raising ValueError: the int8 prefix
(`ops/quant.py::quant_prefix_len`) and a model axis (a layer whose o holds
a rank's rows). `fused_ln` is taken and the frozen tower folds as above.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from ..ops.attention import attention
from ..ops.ln_matmul import ln_matmul
from ..ops.rope import rope, rope_tables
from ..ops.swiglu import swiglu
from ..utils.profiling import span
from .clip import (Params, VisionConfig, _frozen, _lora_delta, _normal,
                   _init_ln, layer_at, layer_norm, linear, ln_stats_mode,
                   mm_f32, pad_tokens, tree_map)


@dataclasses.dataclass(frozen=True)
class EVA02VisionConfig(VisionConfig):
    """The EVA02 ViT: `mlp_hidden` is the SwiGLU width (int(D * mlp_ratio)
    of EVA's config; VisionConfig's `mlp_ratio` is not read), RoPE's grid
    is interpolated from `rope_pretrain_grid`."""
    mlp_hidden: int = 2730
    rope_pretrain_grid: int = 16
    rope_theta: float = 10000.0
    ln_eps: float = 1e-6


def _rope_qk(q: torch.Tensor, k: torch.Tensor,
             cfg: EVA02VisionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k [B, S, D] turned by the tower's tables for S tokens."""
    with span("eva.rope"):
        cos, sin = rope_tables(cfg.grid, cfg.rope_pretrain_grid,
                               cfg.hidden // cfg.heads, cfg.rope_theta,
                               q.shape[1], q.device)
        return rope(q, cos, sin, cfg.heads), rope(k, cos, sin, cfg.heads)


def eva_layer(p: Params, x: torch.Tensor, cfg: EVA02VisionConfig, *,
              lora: Optional[Params] = None, lora_scale: float = 2.0,
              seq_len: Optional[int] = None,
              fold: bool = False) -> torch.Tensor:
    """One EVA02 block (see the module). `lora` adds rank-r updates to q and
    v; `fold` runs LN1 -> qkv and LN_attn -> o through `ln_matmul`'s
    "linear" epilogue (frozen layers only: no LoRA, no gradient)."""
    d, eps = x.shape[-1], cfg.ln_eps
    if p["o"]["w"].shape[-2] != d:
        raise ValueError("the model axis (--mesh_shape d,m with m > 1) is "
                         "not supported on the EVA02 vision tower")
    if fold:
        qkv = ln_matmul(x, p["ln1"]["scale"], p["ln1"]["bias"],
                        p["qkv"]["w"], p["qkv"]["b"], eps, epilogue="linear")
    else:
        h = layer_norm(x, p["ln1"], eps)
        qkv = linear(h, p["qkv"])
    q, k, v = qkv.split(d, dim=-1)
    if lora is not None:
        q = q + _lora_delta(h, lora["q"], lora_scale).to(q.dtype)
        v = v + _lora_delta(h, lora["v"], lora_scale).to(v.dtype)
    q, k = _rope_qk(q, k, cfg)
    a = attention(q, k, v.contiguous(), cfg.heads, False, seq_len)
    if fold:
        out = ln_matmul(a, p["ln_attn"]["scale"], p["ln_attn"]["bias"],
                        p["o"]["w"], p["o"]["b"], eps, epilogue="linear")
    else:
        out = linear(layer_norm(a, p["ln_attn"], eps), p["o"])
    x = x + out
    s = swiglu(linear(layer_norm(x, p["ln2"], eps), p["w12"]))
    return x + linear(layer_norm(s, p["ln_ffn"], eps), p["w3"])


def _run_layers(stacked: Params, x: torch.Tensor, lo: int, hi: int,
                cfg: EVA02VisionConfig, *, remat: bool = False,
                seq_len: Optional[int] = None,
                fold: bool = False) -> torch.Tensor:
    """Layers [lo, hi) without adapters; `remat` checkpoints each layer
    where a gradient flows, as `models.clip._run_layers` does."""
    def layer(i, h):
        return eva_layer(layer_at(stacked, i), h, cfg, seq_len=seq_len,
                         fold=fold)

    remat = remat and torch.is_grad_enabled() and x.requires_grad
    for i in range(lo, hi):
        x = (torch.utils.checkpoint.checkpoint(layer, i, x,
                                               use_reentrant=False)
             if remat else layer(i, x))
    return x


def _features(p: Params, x: torch.Tensor,
              cfg: EVA02VisionConfig) -> torch.Tensor:
    """LN_post on the class token, then the head, in f32."""
    pooled = layer_norm(x[:, 0], p["ln_post"], cfg.ln_eps)
    return mm_f32(pooled, p["head"]["w"]) + p["head"]["b"].float()


def vision_prefix(p: Params, images: torch.Tensor, cfg: EVA02VisionConfig, *,
                  upto: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Patchify + embed + layers [0, upto) -> hidden [B, S_pad, D], folded
    wherever no gradient can reach them and the layernorm is the centered
    one."""
    b = images.shape[0]
    g, pt = cfg.grid, cfg.patch
    x = images.to(compute_dtype)
    x = x.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * pt * pt)
    x = (mm_f32(x, p["patch_embed"].to(compute_dtype))
         + p["patch_bias"].float()).to(compute_dtype)
    cls = p["class_embed"].to(compute_dtype).expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"].to(compute_dtype)
    x, seq_len = pad_tokens(x)
    fold = _frozen(p["layers"], x) and ln_stats_mode() == "centered"
    return _run_layers(p["layers"], x, 0, upto, cfg, seq_len=seq_len,
                       fold=fold)


def vision_from_hidden(p: Params, hidden: torch.Tensor,
                       cfg: EVA02VisionConfig, *,
                       adapters: Optional[Params] = None,
                       adapter_window: Tuple[int, int] = (9, 11),
                       lora_scale: float = 2.0) -> torch.Tensor:
    """Layers [adapter_window[0], end) from a prefix hidden state, LoRA on
    the window where `adapters` (leaves [L, ...] or [S, L, ...]) are given,
    then the features [B, proj_dim] f32. Where a gradient flows, each
    adapted layer is checkpointed: it keeps its input alone and runs its
    forward again in the backward (at L/14@336's 512 views a layer's
    activations took ~22 GB while the plain layernorm kept two f32 copies
    of its centered input, three of them more than the card held; with the
    layernorm kernel and the recompute a step peaks at 19.8 GB on an
    H100)."""
    lo, hi = adapter_window
    x = hidden
    seq_len = None if x.shape[1] == cfg.seq_len else cfg.seq_len
    if adapters is None:
        x = _run_layers(p["layers"], x, lo, cfg.layers, cfg, seq_len=seq_len)
    else:
        remat = torch.is_grad_enabled()
        for i in range(lo, hi + 1):
            def layer(h, i=i):
                lora = tree_map(lambda a: a.select(-3, i - lo), adapters)
                return eva_layer(layer_at(p["layers"], i), h, cfg, lora=lora,
                                 lora_scale=lora_scale, seq_len=seq_len)
            x = (torch.utils.checkpoint.checkpoint(layer, x,
                                                   use_reentrant=False)
                 if remat else layer(x))
        x = _run_layers(p["layers"], x, hi + 1, cfg.layers, cfg, remat=True,
                        seq_len=seq_len)
    return _features(p, x, cfg)


def vision_features(p: Params, images: torch.Tensor, cfg: EVA02VisionConfig,
                    *, adapters: Optional[Params] = None,
                    adapter_window: Tuple[int, int] = (9, 11),
                    lora_scale: float = 2.0, compute_dtype=torch.bfloat16,
                    fused_ln: bool = False) -> torch.Tensor:
    """Images [B, 3, H, W] (CLIP-normalized) -> features [B, proj_dim] f32,
    as `models.clip.vision_features`; `fused_ln` changes nothing (see the
    module)."""
    lo = adapter_window[0] if adapters is not None else cfg.layers
    hidden = vision_prefix(p, images, cfg, upto=lo,
                           compute_dtype=compute_dtype)
    if adapters is None:
        return _features(p, hidden, cfg)
    return vision_from_hidden(p, hidden.detach(), cfg, adapters=adapters,
                              adapter_window=adapter_window,
                              lora_scale=lora_scale)


def init_vision(gen: torch.Generator, v: EVA02VisionConfig) -> Params:
    """Random weights on the host, in this draw order from `gen`: the patch
    embedding, class and position embeddings, then over the stacked layers
    Wq, Wk, Wv, Wo, W1, W2, W3, then the head; then the biases bq, bv, bo,
    b1, b2, b3 over the layers, the patch bias and the head's. Weights and
    embeddings N(0, 0.02), biases N(0, 0.02) (k has none), layernorms 1 and
    0. The benchmark's reference (`reference/arch/eva02.py`) draws the
    same."""
    n, d, f = v.layers, v.hidden, v.mlp_hidden
    patch = _normal(gen, (3 * v.patch * v.patch, d), 0.02)
    cls = _normal(gen, (d,), 0.02)
    pos = _normal(gen, (v.seq_len, d), 0.02)
    w = {name: _normal(gen, (n, d_in, d_out), 0.02)
         for name, d_in, d_out in (("q", d, d), ("k", d, d), ("v", d, d),
                                   ("o", d, d), ("w1", d, f), ("w2", d, f),
                                   ("w3", f, d))}
    head = _normal(gen, (d, v.proj_dim), 0.02)
    b = {name: _normal(gen, (n, width), 0.02)
         for name, width in (("q", d), ("v", d), ("o", d), ("w1", f),
                             ("w2", f), ("w3", d))}
    layers = {
        "ln1": _init_ln((n, d)),
        "qkv": {"w": torch.cat([w["q"], w["k"], w["v"]], dim=-1),
                "b": torch.cat([b["q"], torch.zeros(n, d), b["v"]], dim=-1)},
        "ln_attn": _init_ln((n, d)),
        "o": {"w": w["o"], "b": b["o"]},
        "ln2": _init_ln((n, d)),
        "w12": {"w": torch.cat([w["w1"], w["w2"]], dim=-1),
                "b": torch.cat([b["w1"], b["w2"]], dim=-1)},
        "ln_ffn": _init_ln((n, f)),
        "w3": {"w": w["w3"], "b": b["w3"]},
    }
    return {"patch_embed": patch,
            "patch_bias": _normal(gen, (d,), 0.02),
            "class_embed": cls, "pos_embed": pos, "layers": layers,
            "ln_post": _init_ln(d),
            "head": {"w": head, "b": _normal(gen, (v.proj_dim,), 0.02)}}
