"""AIMv2's towers (the LiT-tuned AIMv2-L/14 at 224 px) as plain functions
over parameter dictionaries.

AIMv2 (arXiv:2411.14402), as transformers' `modeling_aimv2.py` writes it
for `apple/aimv2-large-patch14-224-lit`. A view enters as

    x0 = RMSNorm_e(patches W_patch + b_patch) + pos

with no class token (the grid's g^2 tokens, 256 at 224 px) and learned
positions; each layer is pre-norm, with no bias in any linear:

    h = RMSNorm_1(x);   [q | k | v] = h [Wq | Wk | Wv]
    x = x + softmax(q k^T / sqrt(d)) v Wo
    h = RMSNorm_2(x);   [g | u] = h [Wg | Wu]
    x = x + (SiLU(g) * u) Wd                              (`ops/swiglu.py`)

where RMSNorm(x) = (x * rsqrt(mean(x^2) + eps)) * w, eps 1e-5. The head
pools by attention: y = RMSNorm_f(x); one learned query c [D], split into
the tower's heads with no projection, attends over k = y Wk', v = y Wv'
(no bias); p = softmax(c k^T / sqrt(d)) v; the features are
(p Wout + b_out) Wproj, Wproj the bias-free projection into the shared
space. The text tower (`text_layer`) is the same RMSNorm and bias-free
SwiGLU block, causal, with learned positions, a final RMSNorm, the row at
the first end-of-text token (the largest id, as CLIP's) and a bias-free
projection: CLIP's pooling (`models/clip.py::_pool_eot`).

Layout: a vision layer stores the fused `qkv` ([D, 3D]), `o`, `w12` ([D,
2F]: Wg's columns, then Wu's) and `w3`, each `{"w"}` alone, and the
RMSNorms `ln1`, `ln2` as `{"scale"}`; the tower `ln_embed`, `ln_post`,
`pool_query` [D], `pool_kv` ({"w"} [D, 2D]: Wk' then Wv'), `pool_out`
({"w", "b"}) and `proj` [D, P]. A text layer stores the same keys. F =
2816 at L/14 (rows of 5632 bytes in bf16, on a 16-byte stride: no card
layout is needed).

Numerics are the CLIP towers' (`models/clip.py`): products in the compute
dtype, norm statistics in f32 (`rms_norm`: the port's RMS code of
`ops/layer_norm.py`, the layernorm kernels on the card), attention through
`ops.attention.attention` (K1/K2 at head dim 128 on the card; the causal
text tower takes the einsum numerics), LoRA on q and v by `_lora_delta`, the
patch embedding in f32 with its bias added once. The head runs in f32: the
k/v product in the compute dtype, then scores, softmax, pooling and both
projections in f32, under the span `aimv2.pool`. The norm's affine is
(x * rstd) * w in f32, rounded once (transformers rounds x * rstd to the
input type before the scale; the difference is one rounding).

The tower is a row of `models.clip.TOWERS` ("aimv2", the name
`AIMv2VisionConfig.tower` gives), run by the ViT skeleton of
`models/clip.py`, and its text tower a row of `models.clip.TEXT_TOWERS`.
Where the skeleton folds the prefix (no gradient can reach it), RMSNorm_1
-> qkv and RMSNorm_2 -> w12 each run as one `ln_matmul` call with the RMS
statistics and the "linear" epilogue (K6 on the card, K = 1024, N = 3072
and 5632, a zero bias); o and w3 stay `linear`. The adapted window, the
clean-view passes and any layer a gradient reaches run the same layer
unfolded, which on the CPU is the folded one bit for bit. The window is
not recomputed in the backward (`remat_window` off): the step's
activations fit the card beside the weights.

Not supported on these towers, each raising ValueError: the int8 prefix
(`ops/quant.py::quant_prefix_len`), a model axis (`runner.load_model`, by
the row's `model_axis`; `parallel/mesh.py::param_spec` would split none of
their layers) and `--checkpoint_path` (`models/convert.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import torch

from ..ops import layer_norm as tln
from ..ops.attention import attention
from ..ops.ln_matmul import ln_matmul
from ..ops.swiglu import swiglu
from ..utils.profiling import span
from .clip import (TEXT_TOWERS, TOWERS, Params, TextConfig, TextTower,
                   VisionConfig, ViTTower, _frozen, _lora_delta, _normal,
                   linear, mm_f32, patch_embedding)


@dataclasses.dataclass(frozen=True)
class AIMv2VisionConfig(VisionConfig):
    """The AIMv2 ViT: `mlp_hidden` is the SwiGLU width (VisionConfig's
    `mlp_ratio` is not read); every RMSNorm has `ln_eps`."""
    mlp_hidden: int = 2816
    tower: ClassVar[str] = "aimv2"


@dataclasses.dataclass(frozen=True)
class AIMv2TextConfig(TextConfig):
    """AIMv2's text tower: the SwiGLU width `mlp_hidden`."""
    mlp_hidden: int = 2048
    tower: ClassVar[str] = "aimv2"


def rms_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """(x * rsqrt(mean(x^2) + eps)) * scale, statistics in f32, in x's
    dtype: the layernorm kernels' RMS code on a CUDA tensor (forward and dx
    backward), the plain version on a CPU tensor."""
    if x.is_cuda:
        return tln.layer_norm(x, p["scale"], None, eps, "rms")
    return tln.layer_norm_plain(x, p["scale"], None, eps, "rms")


def _norm_linear(x: torch.Tensor, norm: Params, lin: Params, eps: float,
                 fold: Optional[str]) -> torch.Tensor:
    """linear(rms_norm(x)), as one `ln_matmul` call with the RMS statistics
    where `fold` is set."""
    if fold is None:
        return linear(rms_norm(x, norm, eps), lin)
    return ln_matmul(x, norm["scale"], None, lin["w"], None, eps,
                     epilogue="linear", stats="rms")


def _block(p: Params, x: torch.Tensor, heads: int, eps: float, causal: bool,
           lora: Optional[Params], lora_scale: float, seq_len: Optional[int],
           fold: Optional[str]) -> torch.Tensor:
    """One AIMv2 block (see the module), causal in the text tower."""
    d = x.shape[-1]
    if fold is None:
        h = rms_norm(x, p["ln1"], eps)
        qkv = linear(h, p["qkv"])
    else:
        qkv = _norm_linear(x, p["ln1"], p["qkv"], eps, fold)
    q, k, v = (t.contiguous() for t in qkv.split(d, dim=-1))
    if lora is not None:
        q = q + _lora_delta(h, lora["q"], lora_scale).to(q.dtype)
        v = v + _lora_delta(h, lora["v"], lora_scale).to(v.dtype)
    x = x + linear(attention(q, k, v, heads, causal, seq_len), p["o"])
    s = swiglu(_norm_linear(x, p["ln2"], p["w12"], eps, fold))
    return x + linear(s, p["w3"])


def aimv2_layer(p: Params, x: torch.Tensor, cfg: AIMv2VisionConfig, *,
                lora: Optional[Params] = None, lora_scale: float = 2.0,
                seq_len: Optional[int] = None,
                fold: Optional[str] = None) -> torch.Tensor:
    """One vision block. `lora` adds rank-r updates to q and v; `fold` (any
    value, CoCoOp's "f32" too: the RMS statistics have one epilogue,
    "linear") runs RMSNorm_1 -> qkv and RMSNorm_2 -> w12 through
    `ln_matmul`, in frozen layers only: no LoRA, no gradient."""
    if fold is not None and (lora is not None or not _frozen(p, x)):
        raise ValueError("fold is forward only, without LoRA adapters")
    return _block(p, x, cfg.heads, cfg.ln_eps, False, lora, lora_scale,
                  seq_len, fold)


def text_layer(p: Params, x: torch.Tensor, cfg: AIMv2TextConfig, *,
               lora: Optional[Params] = None,
               lora_scale: float = 2.0) -> torch.Tensor:
    """One causal text block, unfolded."""
    return _block(p, x, cfg.heads, cfg.ln_eps, True, lora, lora_scale, None,
                  None)


def _embed(p: Params, images: torch.Tensor, cfg: AIMv2VisionConfig,
           compute_dtype) -> torch.Tensor:
    """RMSNorm_e of the patch product with its bias (`patch_embedding`),
    then the positions: [B, g^2, D], no class token."""
    x = patch_embedding(p, images, cfg, compute_dtype, p["patch_bias"])
    return rms_norm(x, p["ln_embed"], cfg.ln_eps) \
        + p["pos_embed"].to(compute_dtype)


def _head(p: Params, x: torch.Tensor, cfg: AIMv2VisionConfig) -> torch.Tensor:
    """RMSNorm_f, the k/v product over every token, one learned query's
    attention in f32 over the heads, then Wout + b_out and Wproj in f32."""
    with span("aimv2.pool"):
        b, s, d = x.shape
        y = rms_norm(x, p["ln_post"], cfg.ln_eps)
        k, v = linear(y, p["pool_kv"]).float().split(d, dim=-1)
        heads, dh = cfg.heads, d // cfg.heads
        k = k.reshape(b, s, heads, dh)
        v = v.reshape(b, s, heads, dh)
        c = p["pool_query"].float().reshape(heads, dh)
        scores = torch.einsum("hd,bshd->bhs", c, k) / math.sqrt(dh)
        pooled = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1), v)
        out = mm_f32(pooled.reshape(b, d), p["pool_out"]["w"]) \
            + p["pool_out"]["b"].float()
        return mm_f32(out, p["proj"])


def _final_norm(x: torch.Tensor, p: Params, cfg: AIMv2TextConfig):
    return rms_norm(x, p["ln_final"], cfg.ln_eps)


def _scale(shape) -> Params:
    return {"scale": torch.ones(shape)}


def _layers(gen: torch.Generator, n: int, d: int, f: int) -> Params:
    """Stacked bias-free layers, in this draw order from `gen`: Wq, Wk, Wv,
    Wo, Wg, Wu, Wd, each N(0, 0.02) over all n layers in one call."""
    w = {name: _normal(gen, (n, d_in, d_out), 0.02)
         for name, d_in, d_out in (("q", d, d), ("k", d, d), ("v", d, d),
                                   ("o", d, d), ("g", d, f), ("u", d, f),
                                   ("d", f, d))}
    return {"ln1": _scale((n, d)),
            "qkv": {"w": torch.cat([w["q"], w["k"], w["v"]], dim=-1)},
            "o": {"w": w["o"]},
            "ln2": _scale((n, d)),
            "w12": {"w": torch.cat([w["g"], w["u"]], dim=-1)},
            "w3": {"w": w["d"]}}


def init_vision(gen: torch.Generator, v: AIMv2VisionConfig) -> Params:
    """Random weights on the host, in this draw order from `gen`: the patch
    embedding, the position embedding, the layers (`_layers`), then the
    head's query, Wk', Wv', Wout, the projection, and the biases b_patch and
    b_out. Weights, embeddings, the query and biases N(0, 0.02), RMSNorm
    scales 1. The benchmark's reference (`reference/arch/aimv2.py`) draws
    the same."""
    d = v.hidden
    patch = _normal(gen, (3 * v.patch * v.patch, d), 0.02)
    pos = _normal(gen, (v.seq_len, d), 0.02)
    layers = _layers(gen, v.layers, d, v.mlp_hidden)
    query = _normal(gen, (d,), 0.02)
    wk, wv, wout = (_normal(gen, (d, d), 0.02) for _ in range(3))
    proj = _normal(gen, (d, v.proj_dim), 0.02)
    return {"patch_embed": patch,
            "patch_bias": _normal(gen, (d,), 0.02),
            "ln_embed": _scale(d), "pos_embed": pos, "layers": layers,
            "ln_post": _scale(d), "pool_query": query,
            "pool_kv": {"w": torch.cat([wk, wv], dim=-1)},
            "pool_out": {"w": wout, "b": _normal(gen, (d,), 0.02)},
            "proj": proj}


def init_text(gen: torch.Generator, t: AIMv2TextConfig) -> Params:
    """Random weights on the host, in this draw order from `gen`: token and
    position embeddings (N(0, 0.02), N(0, 0.01)), the layers (`_layers`),
    the projection (N(0, 0.02)); RMSNorm scales 1."""
    token = _normal(gen, (t.vocab, t.hidden), 0.02)
    pos = _normal(gen, (t.ctx, t.hidden), 0.01)
    layers = _layers(gen, t.layers, t.hidden, t.mlp_hidden)
    return {"token_embed": token, "pos_embed": pos, "layers": layers,
            "ln_final": _scale(t.hidden),
            "proj": _normal(gen, (t.hidden, t.proj_dim), 0.02)}


TOWERS["aimv2"] = ViTTower(embed=_embed, block=aimv2_layer, head=_head,
                           init=init_vision, remat_window=False, int8=False,
                           converter=False, class_token=False,
                           model_axis=False)
TEXT_TOWERS["aimv2"] = TextTower(block=text_layer, final_norm=_final_norm,
                                 init=init_text)
