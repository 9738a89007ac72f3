"""CLIP ViT towers as plain functions over parameter dictionaries.

Counterpart of `ttl_tpu/models/clip.py`. Parameters are nested dicts of
tensors in the JAX package's layout: every linear stores `w` as [in, out]
and the transformer layers are stacked on a leading axis, so the weight
bridge (`models/convert.py`) maps one JAX leaf to one tensor.

Numerics follow the JAX towers: matmuls in the compute dtype, layernorm
statistics in f32, the patch embedding and the LoRA products accumulated in
f32 (their operands upcast, which is exact for bf16), the final projection
in f32. Attention goes through `ops.attention.attention`, which follows
`TTL_FUSED_ATTENTION` as the JAX towers do. On the default (bshd) route the
vision tower pads its tokens once per forward to a multiple of 16 (197 ->
208 at ViT-B/16) with zeros and runs the bshd kernel pair, which masks the
pad keys; pad rows ride the residual stream and nothing reads them; the
causal text tower takes the einsum numerics. On the per_head and heads
routes both towers run K3 or K4 unpadded.

With `--prefix_quant int8` the vision parameters carry an int8 copy of the
frozen prefix under `prefix_q` (`ops/quant.py`), and `vision_prefix` runs
those layers through `encoder_layer_q`, whose six linears are K5.

With `fused_ln=True` (the frozen vision tower of the CoCoOp step, under
`torch.no_grad()`), a layer's two layernorms fold into the linears behind
them: q, k, v and fc1 each come from one `ops.ln_matmul.ln_matmul` call, K6
on the card, four launches a layer. It is forward only: LoRA adapters or an
input that a gradient would flow through raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

import torch.utils.checkpoint

from ..ops.attention import attention, fused_mode
from ..ops.ln_matmul import ln_matmul
from ..ops.quant import linear_q

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    hidden: int
    layers: int
    heads: int
    proj_dim: int
    mlp_ratio: int = 4
    ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class VisionConfig(TowerConfig):
    patch: int = 16
    image_size: int = 224

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class TextConfig(TowerConfig):
    vocab: int = 49408
    ctx: int = 77


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: VisionConfig
    text: TextConfig


# ---------------------------------------------------------------- primitives

def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in f32 (JAX's preferred_element_type=float32)."""
    return torch.matmul(a.float(), b.float())


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """Layernorm with f32 statistics and the centered variance, output in
    x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w + b, the bias added in the activation dtype."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_at(stacked: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], stacked)


def _lora_delta(h: torch.Tensor, ad: Params, scale: float) -> torch.Tensor:
    """scale * (h @ A) @ B with bf16 inputs, f32 accumulation and an f32
    rank-r intermediate (the JAX "mixed" LoRA mode). A is [D, r] for one
    adapter set, or [S, D, r] for per-sample adapters over h's leading axis
    split into S equal groups."""
    a, b = ad["A"], ad["B"]
    hh = h if a.dim() == 2 else h.reshape(a.shape[0], -1, h.shape[-1])
    t = mm_f32(hh, a.to(h.dtype))
    return (scale * torch.matmul(t, b)).reshape(h.shape)


def _ln_linear(x: torch.Tensor, ln: Params, lin: Params,
               eps: float) -> torch.Tensor:
    """linear(layer_norm(x)) as one fused call (K6 on the card)."""
    return ln_matmul(x, ln["scale"], ln["bias"], lin["w"], lin["b"], eps)


def _encoder_layer_fused_ln(p: Params, x: torch.Tensor, *, heads: int,
                            eps: float, causal: bool,
                            seq_len: Optional[int]) -> torch.Tensor:
    """encoder_layer for a frozen layer, each layernorm folded into the
    linears that read it."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("fused_ln is forward only: run the layer under "
                         "torch.no_grad() or on an input that needs no "
                         "gradient")
    q, k, v = (_ln_linear(x, p["ln1"], p["attn"][name], eps)
               for name in "qkv")
    x = x + linear(attention(q, k, v, heads, causal, seq_len), p["attn"]["o"])
    fc1 = _ln_linear(x, p["ln2"], p["mlp"]["fc1"], eps)
    return x + linear(quick_gelu(fc1), p["mlp"]["fc2"])


def encoder_layer(p: Params, x: torch.Tensor, *, heads: int, eps: float,
                  causal: bool, lora: Optional[Params] = None,
                  lora_scale: float = 2.0, seq_len: Optional[int] = None,
                  fused_ln: bool = False) -> torch.Tensor:
    """Pre-LN transformer block with a QuickGELU MLP. `lora` adds rank-r
    updates to the q and v projections. `fused_ln` takes q, k, v and fc1
    from `ln_matmul` (frozen layers only: no LoRA, no gradient)."""
    if fused_ln:
        if lora is not None:
            raise ValueError("fused_ln does not take LoRA adapters: the "
                             "fused layernorm + linear has no backward")
        return _encoder_layer_fused_ln(p, x, heads=heads, eps=eps,
                                       causal=causal, seq_len=seq_len)
    h = layer_norm(x, p["ln1"], eps)
    q = linear(h, p["attn"]["q"])
    k = linear(h, p["attn"]["k"])
    v = linear(h, p["attn"]["v"])
    if lora is not None:
        q = q + _lora_delta(h, lora["q"], lora_scale).to(q.dtype)
        v = v + _lora_delta(h, lora["v"], lora_scale).to(v.dtype)
    a = attention(q, k, v, heads, causal, seq_len)
    x = x + linear(a, p["attn"]["o"])
    h = layer_norm(x, p["ln2"], eps)
    return x + linear(quick_gelu(linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])


def encoder_layer_q(pq: Params, x: torch.Tensor, *, heads: int, eps: float,
                    seq_len: Optional[int] = None) -> torch.Tensor:
    """encoder_layer with int8 linears, for frozen vision layers under
    no_grad: layernorms and attention unchanged, no LoRA."""
    h = layer_norm(x, pq["ln1"], eps)
    q = linear_q(h, pq["attn"]["q"])
    k = linear_q(h, pq["attn"]["k"])
    v = linear_q(h, pq["attn"]["v"])
    a = attention(q, k, v, heads, False, seq_len)
    x = x + linear_q(a, pq["attn"]["o"])
    h = layer_norm(x, pq["ln2"], eps)
    return x + linear_q(quick_gelu(linear_q(h, pq["mlp"]["fc1"])),
                        pq["mlp"]["fc2"])


def _run_layers(stacked: Params, x: torch.Tensor, lo: int, hi: int, *,
                heads: int, eps: float, causal: bool, remat: bool = False,
                seq_len: Optional[int] = None,
                fused_ln: bool = False) -> torch.Tensor:
    """Layers [lo, hi) without adapters. With `remat`, where a gradient
    flows, each layer is checkpointed: only its input is saved and its
    internals (the attention inputs and probabilities among them) are
    recomputed in the backward. Exact either way."""
    def layer(i, h):
        return encoder_layer(layer_at(stacked, i), h, heads=heads, eps=eps,
                             causal=causal, seq_len=seq_len,
                             fused_ln=fused_ln)

    remat = remat and torch.is_grad_enabled() and x.requires_grad
    for i in range(lo, hi):
        x = (torch.utils.checkpoint.checkpoint(layer, i, x,
                                               use_reentrant=False)
             if remat else layer(i, x))
    return x


# -------------------------------------------------------------------- towers

def pad_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """Pad the token axis once per vision forward to a multiple of 16, with
    zeros, on the bshd route (the other routes mask no keys). Returns
    (x_padded, true_len), or (x, None) off that route or when already
    aligned."""
    s = x.shape[1]
    sp = ((s + 15) // 16) * 16
    if sp == s or fused_mode() != "bshd":
        return x, None
    pad = torch.zeros(x.shape[0], sp - s, x.shape[2], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1), s


def vision_prefix(p: Params, images: torch.Tensor, cfg: VisionConfig, *,
                  upto: int, compute_dtype=torch.bfloat16,
                  fused_ln: bool = False) -> torch.Tensor:
    """Patchify + embed + frozen layers [0, upto) -> hidden [B, S_pad, D].
    With an int8 copy under p["prefix_q"], its first min(upto, n_q) layers
    run int8 and the fp layers finish the range (none when the whole tower
    is quantised and its fp stack dropped). `fused_ln` applies to the fp
    layers; the int8 layers keep their own linears."""
    b = images.shape[0]
    g, pt = cfg.grid, cfg.patch
    x = images.to(compute_dtype)
    x = x.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * pt * pt)
    x = mm_f32(x, p["patch_embed"].to(compute_dtype)).to(compute_dtype)
    cls = p["class_embed"].to(compute_dtype).expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"].to(compute_dtype)
    x = layer_norm(x, p["ln_pre"], cfg.ln_eps)
    x, seq_len = pad_tokens(x)
    nq = 0
    qp = p.get("prefix_q")
    if qp is not None:
        nq = min(upto, qp["ln1"]["scale"].shape[0])
        for i in range(nq):
            x = encoder_layer_q(layer_at(qp, i), x, heads=cfg.heads,
                                eps=cfg.ln_eps, seq_len=seq_len)
    return _run_layers(p["layers"], x, nq, upto, heads=cfg.heads,
                       eps=cfg.ln_eps, causal=False, seq_len=seq_len,
                       fused_ln=fused_ln)


def vision_from_hidden(p: Params, hidden: torch.Tensor, cfg: VisionConfig, *,
                       adapters: Optional[Params] = None,
                       adapter_window: Tuple[int, int] = (9, 11),
                       lora_scale: float = 2.0) -> torch.Tensor:
    """Layers [adapter_window[0], end) from a prefix hidden state, then
    ln_post on the class token and the f32 projection. `adapters` leaves
    are [L, ...] (one set) or [S, L, ...] (one set per sample)."""
    lo, hi = adapter_window
    x = hidden
    seq_len = None if x.shape[1] == cfg.seq_len else cfg.seq_len
    if adapters is None:
        x = _run_layers(p["layers"], x, lo, cfg.layers, heads=cfg.heads,
                        eps=cfg.ln_eps, causal=False, seq_len=seq_len)
    else:
        for i in range(lo, hi + 1):
            lora = tree_map(lambda a: a.select(-3, i - lo), adapters)
            x = encoder_layer(layer_at(p["layers"], i), x, heads=cfg.heads,
                              eps=cfg.ln_eps, causal=False, lora=lora,
                              lora_scale=lora_scale, seq_len=seq_len)
        x = _run_layers(p["layers"], x, hi + 1, cfg.layers, heads=cfg.heads,
                        eps=cfg.ln_eps, causal=False, remat=True,
                        seq_len=seq_len)
    pooled = layer_norm(x[:, 0], p["ln_post"], cfg.ln_eps)
    return mm_f32(pooled, p["proj"])


def vision_features(p: Params, images: torch.Tensor, cfg: VisionConfig, *,
                    adapters: Optional[Params] = None,
                    adapter_window: Tuple[int, int] = (9, 11),
                    lora_scale: float = 2.0,
                    compute_dtype=torch.bfloat16,
                    fused_ln: bool = False) -> torch.Tensor:
    """Images [B, 3, H, W] (CLIP-normalized) -> features [B, proj_dim] f32.
    `fused_ln` is for the frozen tower: with adapters it raises."""
    if fused_ln and adapters is not None:
        raise ValueError("fused_ln does not take LoRA adapters: the fused "
                         "layernorm + linear has no backward")
    lo = adapter_window[0] if adapters is not None else cfg.layers
    hidden = vision_prefix(p, images, cfg, upto=lo,
                           compute_dtype=compute_dtype, fused_ln=fused_ln)
    if adapters is None:
        pooled = layer_norm(hidden[:, 0], p["ln_post"], cfg.ln_eps)
        return mm_f32(pooled, p["proj"])
    return vision_from_hidden(p, hidden.detach(), cfg, adapters=adapters,
                              adapter_window=adapter_window,
                              lora_scale=lora_scale)


def encode_image(p: Params, images: torch.Tensor, vision_cfg, *,
                 compute_dtype=torch.bfloat16,
                 fused_ln: bool = False) -> torch.Tensor:
    """Backbone dispatcher, frozen features: the ViT tower; the ResNet
    towers raise until they are ported."""
    if not isinstance(vision_cfg, VisionConfig):
        raise NotImplementedError("the ResNet vision towers are not ported "
                                  "yet (ROADMAP Queue 1, item 14)")
    return vision_features(p, images, vision_cfg, compute_dtype=compute_dtype,
                           fused_ln=fused_ln)


def _pool_eot(x: torch.Tensor, tokens: torch.Tensor, p: Params,
              cfg: TextConfig) -> torch.Tensor:
    """ln_final, the EOT row (the largest id) of every prompt, and the f32
    projection. x is [N, ctx', D] with N a multiple of the C rows of
    `tokens`: the table repeats along N."""
    x = layer_norm(x, p["ln_final"], cfg.ln_eps)
    eot = tokens.argmax(dim=-1).repeat(x.shape[0] // tokens.shape[0])
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return mm_f32(pooled, p["proj"])


def text_features(p: Params, tokens: torch.Tensor, cfg: TextConfig, *,
                  adapters: Optional[Params] = None,
                  adapter_window: Tuple[int, int] = (9, 11),
                  lora_scale: float = 2.0,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids [C, ctx'] -> features [C, proj_dim] f32, pooled at the EOT
    (the largest id of each row). ctx' may be a prefix of the context.

    `adapters` puts LoRA on q/v of the layers adapter_window[0] ..
    adapter_window[1]; the layers below run without gradient. Leaves are
    [L, ...] (one set) or [S, L, ...] (one set per sample): then the frozen
    layers run once, their output repeats S times, and the features come out
    as [S*C, proj_dim], sample-major."""
    x = p["token_embed"][tokens].to(compute_dtype)
    x = x + p["pos_embed"][: x.shape[1]].to(compute_dtype)
    run = dict(heads=cfg.heads, eps=cfg.ln_eps, causal=True)
    if adapters is None:
        x = _run_layers(p["layers"], x, 0, cfg.layers, **run)
        return _pool_eot(x, tokens, p, cfg)
    lo, hi = adapter_window
    with torch.no_grad():
        x = _run_layers(p["layers"], x, 0, lo, **run)
    a = adapters["q"]["A"]
    if a.dim() == 4:
        x = x.repeat(a.shape[0], 1, 1)
    for i in range(lo, hi + 1):
        lora = tree_map(lambda t: t.select(-3, i - lo), adapters)
        x = encoder_layer(layer_at(p["layers"], i), x, lora=lora,
                          lora_scale=lora_scale, **run)
    x = _run_layers(p["layers"], x, hi + 1, cfg.layers, remat=True, **run)
    return _pool_eot(x, tokens, p, cfg)


def text_features_from_embeddings(p: Params, embeddings: torch.Tensor,
                                  tokens: torch.Tensor, cfg: TextConfig, *,
                                  compute_dtype=torch.bfloat16,
                                  remat: bool = False) -> torch.Tensor:
    """Prompt embeddings [N, ctx', hidden] -> features [N, proj_dim] f32:
    the prompt-tuning path assembles its prompts in embedding space.
    `tokens` [C, ctx'] gives the EOT positions (N a multiple of C). With
    `remat` every layer is checkpointed: the whole tower is differentiated
    with respect to the embeddings at every step, and the saved attention
    probabilities of all layers would otherwise stay alive together."""
    x = embeddings.to(compute_dtype) \
        + p["pos_embed"][: embeddings.shape[1]].to(compute_dtype)
    x = _run_layers(p["layers"], x, 0, cfg.layers, heads=cfg.heads,
                    eps=cfg.ln_eps, causal=True, remat=remat)
    return _pool_eot(x, tokens, p, cfg)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def cosine_logits(image_feats: torch.Tensor, text_feats: torch.Tensor,
                  logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(logit_scale) * norm(img) @ norm(text).T, in f32."""
    img = l2_normalize(image_feats.float())
    txt = l2_normalize(text_feats.float())
    return torch.exp(logit_scale.float()) * img @ txt.T


# ------------------------------------------------------------ initialization

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _init_ln(shape) -> Params:
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def _init_linear(gen, n, d_in, d_out) -> Params:
    return {"w": _normal(gen, (n, d_in, d_out), 0.02),
            "b": torch.zeros(n, d_out)}


def _init_layers(gen, n, d, mlp_ratio) -> Params:
    return {
        "ln1": _init_ln((n, d)),
        "ln2": _init_ln((n, d)),
        "attn": {name: _init_linear(gen, n, d, d) for name in "qkvo"},
        "mlp": {"fc1": _init_linear(gen, n, d, d * mlp_ratio),
                "fc2": _init_linear(gen, n, d * mlp_ratio, d)},
    }


def _placed(tree, device, dtype, in_ln: bool = False):
    """Move a host tree to `device`: layernorm leaves f32, the rest dtype."""
    if isinstance(tree, dict):
        return {k: _placed(v, device, dtype, in_ln or k.startswith("ln"))
                for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32 if in_ln else dtype)


def init_clip_params(cfg: CLIPConfig, gen: torch.Generator, *,
                     device, param_dtype=torch.float32) -> Params:
    """Random weights in the JAX package's distributions and layout, drawn
    from `gen` on the host: for runs that have no checkpoint. Layernorm
    parameters and logit_scale stay f32, every other leaf is param_dtype."""
    v, t = cfg.vision, cfg.text
    vision = {
        "patch_embed": _normal(gen, (3 * v.patch * v.patch, v.hidden), 0.02),
        "class_embed": _normal(gen, (v.hidden,), 0.02),
        "pos_embed": _normal(gen, (v.seq_len, v.hidden), 0.02),
        "ln_pre": _init_ln(v.hidden),
        "layers": _init_layers(gen, v.layers, v.hidden, v.mlp_ratio),
        "ln_post": _init_ln(v.hidden),
        "proj": _normal(gen, (v.hidden, v.proj_dim), 0.02),
    }
    text = {
        "token_embed": _normal(gen, (t.vocab, t.hidden), 0.02),
        "pos_embed": _normal(gen, (t.ctx, t.hidden), 0.01),
        "layers": _init_layers(gen, t.layers, t.hidden, t.mlp_ratio),
        "ln_final": _init_ln(t.hidden),
        "proj": _normal(gen, (t.hidden, t.proj_dim), 0.02),
    }

    return {"vision": _placed(vision, device, param_dtype),
            "text": _placed(text, device, param_dtype),
            "logit_scale": torch.tensor(math.log(1.0 / 0.07),
                                        dtype=torch.float32, device=device)}
