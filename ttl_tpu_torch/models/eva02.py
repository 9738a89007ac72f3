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
F = `mlp_hidden` (2730 at L/14), also where the card stores it padded.

Layout: a layer stores the fused `qkv` ([D, 3D], its bias [3D] zero in k's
third) and `w12` ([D, 2F]: W1's columns, then W2's), `o`, `w3` and the four
layernorms `ln1`, `ln_attn`, `ln2`, `ln_ffn`; layers are stacked on a
leading axis as in `models/clip.py`.

On a CUDA device the MLP is stored at Fp, F rounded up to a multiple of
MLP_ALIGN = 8 columns (2730 -> 2736), so that the rows of the hidden s,
of [u | g] and of the weights around them start on 16-byte boundaries in
bf16: cuBLAS runs such products on Hopper's kernels, and at 2730 (rows of
5460 bytes) on Ampere's 2-element-aligned ones. `card_layout` pads the host
tree once, where `init_clip_params` places it on the card (the row's
`ViTTower.card_layout`): `w12` [D, 2Fp] is [W1 | 0 | W2 | 0] and its bias
[b1 | 0 | b2 | 0], `w3` [Fp, D] has zero rows past F, `ln_ffn`'s scale and
bias [Fp] zeros past F. The padded columns carry exact zeros through the
block: u = g = 0 there, so SwiGLU gives SiLU(0) * 0 = 0, LN_ffn normalises
the first F columns alone (`layer_norm`'s logical width) and writes 0 past
them, and w3's zero rows drop them; backward, LN_ffn's dx is 0 past F, so
du = dg = 0 there. An F already on the stride is left as it is, and the CPU
keeps the unpadded layout.

Numerics are the CLIP towers' (`models/clip.py`): products in the compute
dtype with the bias added in that dtype (`linear`), layernorm statistics in
f32, attention through `ops.attention.attention` with the tokens padded once
a forward on the bshd route (577 -> 592 at L/14@336), LoRA on q and v by
`_lora_delta` (q's delta added before RoPE), the patch embedding and the
head in f32. RoPE runs under the span `eva.rope`, q and k of a layer in one.

The tower is a row of `models.clip.TOWERS` ("eva02", the name
`EVA02VisionConfig.tower` gives): its embedding, its block (`eva_layer`),
its head and its weight draw, run by the ViT skeleton of `models/clip.py`
(`vision_prefix`, `vision_from_hidden`, `vision_features`).

Where the skeleton folds the prefix (no gradient can reach it, centered
statistics), LN1 -> qkv and LN_attn -> o each run as one `ln_matmul` call
with the "linear" epilogue (K6 on the card, K = 1024, N = 3072 and 1024);
LN2 -> w12 is `layer_norm` and one product, then the SwiGLU kernel; LN_ffn
and w3 stay `layer_norm` and `linear` (K6 takes K and N in multiples of 16
and holds its K-wide row tile in shared memory; neither 2730 nor 2736 is
one). On the card each `layer_norm` is the layernorm kernel
(`ops/layer_norm.py`). The
adapted window, the clean-view passes and any layer a gradient reaches run
the same layer unfolded, which on the CPU is the folded one bit for bit.
The row asks for the adapted layers to be recomputed in the backward
(`remat_window`), so a step runs their forward twice.

Not supported on this tower, each raising ValueError: the int8 prefix
(`ops/quant.py::quant_prefix_len`), a model axis (`--mesh_shape d,m`,
m > 1: `runner.check_model_axis`) and `--checkpoint_path`
(`models/convert.py`).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.ln_matmul import ln_matmul
from ..ops.rope import rope, rope_tables
from ..ops.swiglu import swiglu
from ..utils.profiling import span
from .clip import (TOWERS, Params, VisionConfig, ViTTower, _frozen,
                   _lora_delta, _normal, _init_ln, layer_norm, linear,
                   ln_stats_mode, mm_f32, patch_tokens)


@dataclasses.dataclass(frozen=True)
class EVA02VisionConfig(VisionConfig):
    """The EVA02 ViT: `mlp_hidden` is the SwiGLU width (int(D * mlp_ratio)
    of EVA's config; VisionConfig's `mlp_ratio` is not read), RoPE's grid
    is interpolated from `rope_pretrain_grid`."""
    mlp_hidden: int = 2730
    rope_pretrain_grid: int = 16
    rope_theta: float = 10000.0
    ln_eps: float = 1e-6
    tower: ClassVar[str] = "eva02"


# the MLP's stored width on the card is a multiple of this many columns: 16
# bytes of bf16, the narrowest dtype the tower computes in
MLP_ALIGN = 8


def mlp_stride(f: int) -> int:
    """The stored width of an F-wide SwiGLU hidden on the card."""
    return -(-f // MLP_ALIGN) * MLP_ALIGN


def card_layout(vision: Params, cfg: EVA02VisionConfig) -> Params:
    """The host tree with its MLP padded from F to `mlp_stride(F)` columns
    with zeros (see the module): a new tree, the rest of its leaves shared;
    `vision` itself where F is already on the stride."""
    f = cfg.mlp_hidden
    pad = mlp_stride(f) - f
    if pad == 0:
        return vision
    layers = vision["layers"]

    def halves(t):        # [..., 2F] -> [..., 2Fp]: [a | 0 | b | 0]
        a, b = t.split(f, dim=-1)
        return torch.cat([F.pad(a, (0, pad)), F.pad(b, (0, pad))], dim=-1)

    mlp = {"w12": {n: halves(t) for n, t in layers["w12"].items()},
           "w3": {"w": F.pad(layers["w3"]["w"], (0, 0, 0, pad)),
                  "b": layers["w3"]["b"]},
           "ln_ffn": {n: F.pad(t, (0, pad))
                      for n, t in layers["ln_ffn"].items()}}
    return {**vision, "layers": {**layers, **mlp}}


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
              fold: Optional[str] = None) -> torch.Tensor:
    """One EVA02 block (see the module). `lora` adds rank-r updates to q and
    v; `fold="linear"` runs LN1 -> qkv and LN_attn -> o through
    `ln_matmul`'s "linear" epilogue (frozen layers only: no LoRA, no
    gradient). This block has never honoured CoCoOp's "f32" request: under
    it the block folds as the skeleton would without it."""
    d, eps = x.shape[-1], cfg.ln_eps
    if fold == "f32":
        fold = ("linear" if _frozen(p, x) and ln_stats_mode() == "centered"
                else None)
    if fold is not None:
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
    if fold is not None:
        out = ln_matmul(a, p["ln_attn"]["scale"], p["ln_attn"]["bias"],
                        p["o"]["w"], p["o"]["b"], eps, epilogue="linear")
    else:
        out = linear(layer_norm(a, p["ln_attn"], eps), p["o"])
    x = x + out
    s = swiglu(linear(layer_norm(x, p["ln2"], eps), p["w12"]))
    return x + linear(layer_norm(s, p["ln_ffn"], eps, cfg.mlp_hidden),
                      p["w3"])


def _embed(p: Params, images: torch.Tensor, cfg: EVA02VisionConfig,
           compute_dtype) -> torch.Tensor:
    """The patch tokens with the patch bias, no ln_pre."""
    return patch_tokens(p, images, cfg, compute_dtype, p["patch_bias"])


def _head(p: Params, x: torch.Tensor, cfg: EVA02VisionConfig) -> torch.Tensor:
    """LN_post on the class token, then the head, in f32."""
    pooled = layer_norm(x[:, 0], p["ln_post"], cfg.ln_eps)
    return mm_f32(pooled, p["head"]["w"]) + p["head"]["b"].float()


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


# At L/14@336's 512 views an adapted layer's activations took ~22 GB while
# the plain layernorm kept two f32 copies of its centered input, three of
# them more than the card held; with the layernorm kernel and the window
# recomputed in the backward a step peaks at 19.8 GB on an H100.
TOWERS["eva02"] = ViTTower(embed=_embed, block=eva_layer, head=_head,
                           init=init_vision, remat_window=True, int8=False,
                           converter=False, card_layout=card_layout,
                           model_axis=False)
