"""CLIP ViT towers as plain functions over parameter dictionaries, and the
skeleton every ViT architecture runs in.

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
routes both towers run K3 or K4 unpadded. On the card `layer_norm` runs
the layernorm kernels of `ops/layer_norm.py` (forward and dx backward);
the CPU keeps the plain version bit for bit.

With `--prefix_quant int8` the vision parameters carry an int8 copy of the
frozen prefix under `prefix_q` (`ops/quant.py`), and `vision_prefix` runs
those layers through `encoder_layer_q`, whose six linears are K5.

Two numerics switches are read as the JAX towers read them, at each call:
`TTL_LN_STATS` (`centered`, the default, or `ex2`: E[x^2] - mu^2) for the
layernorm variance, and `TTL_LORA_COMPUTE` (`mixed`, the default: A in the
activation dtype, f32 accumulation; or `f32`: the activation upcast first)
for the LoRA products. An unknown value raises ValueError.

`fuse_qkv_params` rewrites a tower's q, k and v into one [L, D, 3D] `qkv`
projection, which `encoder_layer` takes as one product (and, folded, one K6
launch).

The ViT skeleton (`vision_prefix`, `vision_from_hidden`, `vision_features`)
is written once. A vision config names its architecture
(`VisionConfig.tower`), and `TOWERS` maps the name to a `ViTTower`: its
embedding, its block, its head, its weight draw, and whether its adapted
window is recomputed in the backward, it takes the int8 prefix and a
checkpoint converter reads it, and whether its tokens begin with a class
token (`VisionConfig.seq_len` reads it). CLIP's row is here;
`models/eva02.py` adds EVA02's and `models/aimv2.py` AIMv2's. The text
tower has one skeleton too (`text_features`,
`text_features_from_embeddings`): a text config names its architecture
(`TextConfig.tower`), and `TEXT_TOWERS` maps it to a `TextTower` (its
causal block, its final norm and its weight draw); CLIP's row takes the
activation `TextConfig.act` names, AIMv2's is its own block.

The skeleton decides once, in `vision_prefix`, whether the frozen layers
fold each layernorm into the linears behind it (`encoder_layer`'s `fold`,
one `ops.ln_matmul.ln_matmul` call each for q, k, v and fc1, K6 on the
card). By default they fold wherever no gradient can reach them
(`_frozen`: grad mode off, or neither the input nor the layers' weights
need one; the TTL step's prefix runs under `torch.no_grad()`), with K6's
"linear" epilogue: the product rounded and the bias added in the activation
dtype as `linear` does, and at fc1 QuickGELU at the points where
`quick_gelu` rounds. That is the function of `layer_norm` -> `linear` ->
`quick_gelu`, the same bits on the CPU; on the card only the order of the
product's sums differs. K6 computes the centered variance only, so under
TTL_LN_STATS=ex2 the layers stay unfolded. `fold="f32"` is the request of
the CoCoOp step's frozen tower, under `torch.no_grad()`: K6 with the JAX
`ln_matmul`'s epilogue (the bias in f32, one rounding) under either
statistics. A folded layer is forward only: LoRA adapters or an input that
a gradient would flow through raise.

`encode_image` dispatches a ResNet tower (`models/resnet.py`) to
`resnet_features`, and `init_clip_params` draws one where the config asks
for it.

On a model axis (`parallel/mesh.py::shard_params`) a layer's weights are
the rank's slice: q/k/v and fc1 its columns, o and fc2 its rows. A layer
sees that from o's rows and runs its heads // m heads (K1/K2 at the rank's
head count); the input of its column-split products goes through
`copy_to_model` (the gradient summed over the group), and the partial
products of o and fc2 are summed over the group in f32 (`reduce_from_model`)
and rounded once before the bias is added once, as `linear` rounds and adds
it on one card. LoRA adapters stay whole: a rank's q/v delta takes B's
columns of its heads, and A and B enter through `copy_to_model`, so their
gradients are the whole tower's on every rank. The int8 prefix is not
split: `encoder_layer_q` runs it whole on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, ClassVar, Dict, NamedTuple, Optional,
                    Tuple, Union)

import torch

import torch.utils.checkpoint

from ..ops.attention import attention, env_choice, fused_mode
from ..ops import layer_norm as tln
from ..ops.ln_matmul import ln_matmul
from ..ops.quant import linear_q
from ..parallel import tensor as tp
from .resnet import ResNetVisionConfig, init_resnet_params, resnet_features

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
    # the architecture, a key of TOWERS: a class constant, as TextConfig's
    # `act` is
    tower: ClassVar[str] = "clip"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @property
    def seq_len(self) -> int:
        """The patch tokens, and the class token where the tower has one
        (`ViTTower.class_token`)."""
        return self.grid * self.grid + int(TOWERS[self.tower].class_token)


@dataclasses.dataclass(frozen=True)
class TextConfig(TowerConfig):
    vocab: int = 49408
    ctx: int = 77
    # the MLP's activation, a key of ACTIVATIONS: a class constant, so that
    # the fields stay the JAX package's TextConfig's
    act: ClassVar[str] = "quick_gelu"
    # the architecture, a key of TEXT_TOWERS
    tower: ClassVar[str] = "clip"


@dataclasses.dataclass(frozen=True)
class GELUTextConfig(TextConfig):
    """OpenCLIP's text tower with the exact GELU (EVA02-CLIP's)."""
    act: ClassVar[str] = "gelu"


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: Union[VisionConfig, ResNetVisionConfig]
    text: TextConfig


# ---------------------------------------------------------------- primitives

def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in f32 (JAX's preferred_element_type=float32)."""
    return torch.matmul(a.float(), b.float())


def ln_stats_mode() -> str:
    """TTL_LN_STATS: 'centered' (default) or 'ex2'."""
    return env_choice("TTL_LN_STATS", ("centered", "ex2"))


def lora_compute_mode() -> str:
    """TTL_LORA_COMPUTE: 'mixed' (default) or 'f32'."""
    return env_choice("TTL_LORA_COMPUTE", ("mixed", "f32"))


def layer_norm(x: torch.Tensor, p: Params, eps: float,
               width: Optional[int] = None) -> torch.Tensor:
    """Layernorm with f32 statistics, output in x's dtype. The variance is
    the centered mean((x - mu)^2), or with TTL_LN_STATS=ex2 E[x^2] - mu^2
    floored at 0. `width`: normalise the first `width` columns of a padded
    row, 0 past them (`ops/layer_norm.py`). A CUDA tensor runs the
    hand-written kernels, forward and dx backward (`ops.layer_norm.
    layer_norm`, which raises on a dtype or width they do not take and on a
    scale or bias that needs a gradient); a CPU tensor the plain version
    (`layer_norm_plain`)."""
    stats = ln_stats_mode()
    if x.is_cuda:
        return tln.layer_norm(x, p["scale"], p["bias"], eps, stats, width)
    return tln.layer_norm_plain(x, p["scale"], p["bias"], eps, stats, width)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU: OpenCLIP's text tower where `quick_gelu` is
    not set (EVA02-CLIP's)."""
    return torch.nn.functional.gelu(x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu}


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w + b, the bias added in the activation dtype."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def tree_map(fn, tree):
    """fn over every leaf of a tree of dicts and lists (a ResNet tower keeps
    its blocks in lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def layer_at(stacked: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], stacked)


def _lora_delta(h: torch.Tensor, ad: Params, scale: float) -> torch.Tensor:
    """scale * (h @ A) @ B in f32. In the default "mixed" mode A is rounded
    to h's dtype and the products accumulate in f32 with an f32 rank-r
    intermediate; with TTL_LORA_COMPUTE=f32, A stays f32 and the scale
    applies before B, as the JAX expression is written. A is [D, r] for one
    adapter set, or [S, D, r] for per-sample adapters over h's leading axis
    split into S equal groups."""
    a, b = ad["A"], ad["B"]
    hh = h if a.dim() == 2 else h.reshape(a.shape[0], -1, h.shape[-1])
    if lora_compute_mode() == "f32":
        out = torch.matmul(scale * mm_f32(hh, a), b)
    else:
        out = scale * torch.matmul(mm_f32(hh, a.to(h.dtype)), b)
    return out.reshape(*h.shape[:-1], b.shape[-1])


def fuse_qkv_params(tower: Params) -> Params:
    """A tower whose stacked layers carry one fused `qkv` projection
    ([L, D, 3D] weight, [L, 3D] bias: q, k, v side by side) in place of q,
    k and v: a layout transform that `encoder_layer` detects. Not applied
    by default; the int8 prefix (`ops/quant.py`) refuses it."""
    attn = tower["layers"]["attn"]
    fused = {"qkv": {key: torch.cat([attn[name][key] for name in "qkv"],
                                    dim=-1) for key in ("w", "b")},
             "o": attn["o"]}
    return {**tower, "layers": {**tower["layers"], "attn": fused}}


def _split_qkv(qkv: torch.Tensor):
    """A fused projection's output [..., 3D] -> contiguous q, k, v."""
    return [t.contiguous() for t in qkv.chunk(3, dim=-1)]


def _ln_linear(x: torch.Tensor, ln: Params, lin: Params, eps: float,
               epilogue: str, gelu: bool = False) -> torch.Tensor:
    """linear(layer_norm(x)) as one fused call (K6 on the card), with K6's
    `epilogue` ("f32" or "linear"); `gelu` adds QuickGELU to "linear"'s."""
    return ln_matmul(x, ln["scale"], ln["bias"], lin["w"], lin["b"], eps,
                     epilogue=epilogue, quick_gelu=gelu)


def _model_split(p: Params, x: torch.Tensor,
                 heads: int) -> Tuple[Optional[tp.ModelGroup], int]:
    """(the step's model group, the rank's head count) for a layer whose
    weights are a rank's slice (o's input rows fewer than the width);
    (None, heads) for a whole layer."""
    rows, width = p["attn"]["o"]["w"].shape[-2], x.shape[-1]
    if rows == width:
        return None, heads
    if heads * rows % width:
        raise ValueError(f"{heads} heads do not split over a model axis "
                         f"of {width // rows}")
    return tp.active(), heads * rows // width


def _out_linear(x: torch.Tensor, p: Params,
                mg: Optional[tp.ModelGroup]) -> torch.Tensor:
    """linear(x, p) for o and fc2. On a model group x and w's rows are the
    rank's: the partial product, in f32, is summed over the group, rounded
    once to x's dtype, and the bias added once."""
    if mg is None:
        return linear(x, p)
    y = tp.reduce_from_model(mm_f32(x, p["w"].to(x.dtype)), mg)
    return y.to(x.dtype) + p["b"].to(x.dtype)


def _lora_columns(lora: Params, mg: tp.ModelGroup) -> Params:
    """Whole adapters on a rank of a model group: A, and B's columns of the
    rank's heads, each through `copy_to_model`."""
    out = {}
    for name, ad in lora.items():
        b = tp.copy_to_model(ad["B"], mg)
        n = b.shape[-1] // mg.size
        out[name] = {"A": tp.copy_to_model(ad["A"], mg),
                     "B": b[..., mg.index * n:(mg.index + 1) * n]}
    return out


def encoder_layer(p: Params, x: torch.Tensor, *, heads: int, eps: float,
                  causal: bool, lora: Optional[Params] = None,
                  lora_scale: float = 2.0, seq_len: Optional[int] = None,
                  fold: Optional[str] = None,
                  act: str = "quick_gelu") -> torch.Tensor:
    """Pre-LN transformer block with an MLP whose activation `act` names
    (QuickGELU by default). `lora` adds rank-r
    updates to the q and v projections. A layer with a fused `qkv`
    projection (`fuse_qkv_params`) takes q, k and v from one product.
    `fold` names K6's epilogue where each layernorm folds into the linears
    that read it, q, k, v and fc1 each one `ln_matmul` call: "f32" (the
    JAX `ln_matmul`'s) or "linear" (`linear`'s roundings, QuickGELU in
    fc1's); None runs the layer unfolded. A folded layer is frozen: no
    LoRA, no gradient, QuickGELU."""
    if fold is not None:
        if lora is not None:
            raise ValueError("fold does not take LoRA adapters: the fused "
                             "layernorm + linear has no backward")
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("fold is forward only: run the layer under "
                             "torch.no_grad() or on an input that needs no "
                             "gradient")
    mg, heads = _model_split(p, x, heads)
    if fold is None:
        h = layer_norm(x, p["ln1"], eps)
        if mg is not None:
            h = tp.copy_to_model(h, mg)
            if lora is not None:
                lora = _lora_columns(lora, mg)

        def proj(lin):
            return linear(h, lin)
    else:
        def proj(lin):
            return _ln_linear(x, p["ln1"], lin, eps, fold)
    if "qkv" in p["attn"]:
        q, k, v = _split_qkv(proj(p["attn"]["qkv"]))
    else:
        q, k, v = (proj(p["attn"][name]) for name in "qkv")
    if lora is not None:
        q = q + _lora_delta(h, lora["q"], lora_scale).to(q.dtype)
        v = v + _lora_delta(h, lora["v"], lora_scale).to(v.dtype)
    a = attention(q, k, v, heads, causal, seq_len)
    x = x + _out_linear(a, p["attn"]["o"], mg)
    if fold is None:
        h = layer_norm(x, p["ln2"], eps)
        if mg is not None:
            h = tp.copy_to_model(h, mg)
        h = ACTIVATIONS[act](linear(h, p["mlp"]["fc1"]))
    elif fold == "f32":
        h = quick_gelu(_ln_linear(x, p["ln2"], p["mlp"]["fc1"], eps, fold))
    else:
        h = _ln_linear(x, p["ln2"], p["mlp"]["fc1"], eps, fold, gelu=True)
    return x + _out_linear(h, p["mlp"]["fc2"], mg)


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


def _run_layers(stacked: Params, x: torch.Tensor, lo: int, hi: int,
                block: Callable, *, remat: bool = False,
                adapters: Optional[Params] = None, **kw) -> torch.Tensor:
    """Layers [lo, hi) of `stacked`, each `block(layer, x, **kw)`.
    `adapters` (leaves [L, ...] or [S, L, ...], L counted from lo) give
    each layer its `lora`. With `remat`, where a gradient flows (through x,
    or into the adapters), each layer is checkpointed: only its input is
    saved and its internals (the attention inputs and probabilities among
    them) are recomputed in the backward. Exact either way."""
    def layer(i, h):
        lora = {} if adapters is None else {
            "lora": tree_map(lambda a: a.select(-3, i - lo), adapters)}
        return block(layer_at(stacked, i), h, **lora, **kw)

    remat = remat and torch.is_grad_enabled() and (
        adapters is not None or x.requires_grad)
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


def _frozen(stacked: Params, x: torch.Tensor) -> bool:
    """Whether no gradient can reach layers of `stacked` run on x: grad mode
    is off, or neither x nor any of the layers' weights needs one."""
    if not torch.is_grad_enabled():
        return True
    leaves = []
    tree_map(leaves.append, stacked)
    return not x.requires_grad and not any(t.requires_grad for t in leaves)


class ViTTower(NamedTuple):
    """A ViT architecture's pieces, under the name its vision config gives
    (`VisionConfig.tower`); `vision_prefix`, `vision_from_hidden` and
    `vision_features` are the skeleton around them."""
    # (p, images, cfg, compute_dtype) -> tokens [B, S, D], unpadded
    embed: Callable
    # (layer, x, cfg, *, lora, lora_scale, seq_len, fold) -> x
    block: Callable
    # (p, x, cfg) -> features [B, proj_dim] f32, pooled from x
    head: Callable
    # (gen, cfg) -> the tower's weights on the host
    init: Callable
    # the adapted window is checkpointed where a gradient flows
    remat_window: bool
    # the frozen prefix may run int8 (`ops/quant.py`)
    int8: bool
    # a checkpoint converter reads it (`models/convert.py`)
    converter: bool
    # (host weights, cfg) -> the weights as a CUDA device holds them, where
    # they differ (EVA02's padded MLP, `models/eva02.py::card_layout`)
    card_layout: Optional[Callable] = None
    # the tokens begin with a class token (AIMv2's pool all of them)
    class_token: bool = True
    # its layers may be split over a model axis (`parallel/mesh.py`)
    model_axis: bool = True


class TextTower(NamedTuple):
    """A text architecture's pieces, under the name its text config gives
    (`TextConfig.tower`); `text_features` and
    `text_features_from_embeddings` are the skeleton around them."""
    # (layer, x, cfg, *, lora, lora_scale) -> x, causal
    block: Callable
    # (x, p, cfg) -> x normalised before the end-of-text row is read
    final_norm: Callable
    # (gen, cfg) -> the tower's weights on the host
    init: Callable


def patch_embedding(p: Params, images: torch.Tensor, cfg: VisionConfig,
                    compute_dtype, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Patchify, the patch product in f32 (plus `bias` in f32), rounded
    once: [B, grid^2, D]."""
    b = images.shape[0]
    g, pt = cfg.grid, cfg.patch
    x = images.to(compute_dtype)
    x = x.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * pt * pt)
    x = mm_f32(x, p["patch_embed"].to(compute_dtype))
    if bias is not None:
        x = x + bias.float()
    return x.to(compute_dtype)


def patch_tokens(p: Params, images: torch.Tensor, cfg: VisionConfig,
                 compute_dtype, bias: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """`patch_embedding`, then the class token and the positions: [B, S,
    D]."""
    x = patch_embedding(p, images, cfg, compute_dtype, bias)
    cls = p["class_embed"].to(compute_dtype).expand(x.shape[0], 1,
                                                    cfg.hidden)
    return torch.cat([cls, x], dim=1) + p["pos_embed"].to(compute_dtype)


def vision_prefix(p: Params, images: torch.Tensor, cfg: VisionConfig, *,
                  upto: int, compute_dtype=torch.bfloat16,
                  fold: Optional[str] = None) -> torch.Tensor:
    """Patchify + embed + frozen layers [0, upto) -> hidden [B, S_pad, D].
    With an int8 copy under p["prefix_q"], its first min(upto, n_q) layers
    run int8 and the fp layers finish the range (none when the whole tower
    is quantised and its fp stack dropped). The fp layers fold each
    layernorm into the linears behind it with K6's "linear" epilogue
    wherever no gradient can reach them (`_frozen`) and the layernorm is
    the centered one, and run unfolded elsewhere; `fold="f32"` (CoCoOp's
    request) folds them with K6's "f32" epilogue under either statistics.
    The int8 layers keep their own linears."""
    tower = TOWERS[cfg.tower]
    x, seq_len = pad_tokens(tower.embed(p, images, cfg, compute_dtype))
    nq = 0
    qp = p.get("prefix_q")
    if qp is not None:
        nq = min(upto, qp["ln1"]["scale"].shape[0])
        for i in range(nq):
            x = encoder_layer_q(layer_at(qp, i), x, heads=cfg.heads,
                                eps=cfg.ln_eps, seq_len=seq_len)
    if (fold is None and _frozen(p["layers"], x)
            and ln_stats_mode() == "centered"):
        fold = "linear"
    return _run_layers(p["layers"], x, nq, upto, tower.block, cfg=cfg,
                       seq_len=seq_len, fold=fold)


def vision_from_hidden(p: Params, hidden: torch.Tensor, cfg: VisionConfig, *,
                       adapters: Optional[Params] = None,
                       adapter_window: Tuple[int, int] = (9, 11),
                       lora_scale: float = 2.0) -> torch.Tensor:
    """Layers [adapter_window[0], end) from a prefix hidden state, LoRA on
    the window where `adapters` (leaves [L, ...] or [S, L, ...]) are given,
    then the tower's head: features [B, proj_dim] f32. Where a gradient
    flows, the layers after the window are checkpointed, and the window's
    too where the tower asks for it (`ViTTower.remat_window`)."""
    tower = TOWERS[cfg.tower]
    lo, hi = adapter_window
    x = hidden
    run = dict(cfg=cfg,
               seq_len=None if x.shape[1] == cfg.seq_len else cfg.seq_len)
    if adapters is not None:
        x = _run_layers(p["layers"], x, lo, hi + 1, tower.block,
                        remat=tower.remat_window, adapters=adapters,
                        lora_scale=lora_scale, **run)
        lo = hi + 1
    x = _run_layers(p["layers"], x, lo, cfg.layers, tower.block,
                    remat=adapters is not None, **run)
    return tower.head(p, x, cfg)


def vision_features(p: Params, images: torch.Tensor, cfg: VisionConfig, *,
                    adapters: Optional[Params] = None,
                    adapter_window: Tuple[int, int] = (9, 11),
                    lora_scale: float = 2.0,
                    compute_dtype=torch.bfloat16,
                    fold: Optional[str] = None) -> torch.Tensor:
    """Images [B, 3, H, W] (CLIP-normalized) -> features [B, proj_dim] f32:
    `vision_prefix`, then `vision_from_hidden` on its output (detached
    where adapters are given). `fold="f32"` is for the frozen tower: with
    adapters it raises."""
    if fold is not None and adapters is not None:
        raise ValueError("fold does not take LoRA adapters: the fused "
                         "layernorm + linear has no backward")
    lo = adapter_window[0] if adapters is not None else cfg.layers
    hidden = vision_prefix(p, images, cfg, upto=lo,
                           compute_dtype=compute_dtype, fold=fold)
    return vision_from_hidden(
        p, hidden if adapters is None else hidden.detach(), cfg,
        adapters=adapters, adapter_window=(lo, adapter_window[1]),
        lora_scale=lora_scale)


def encode_image(p: Params, images: torch.Tensor, vision_cfg, *,
                 compute_dtype=torch.bfloat16, fold: Optional[str] = None,
                 **lora_kw) -> torch.Tensor:
    """Backbone dispatcher: a ViT tower (VisionConfig, any of TOWERS) or the
    ModifiedResNet (ResNetVisionConfig). The LoRA kwargs of
    `vision_features` apply to the ViT only, as in the reference; a ResNet
    given adapters raises. A ResNet has no layernorm to fold, so it ignores
    `fold`."""
    if isinstance(vision_cfg, VisionConfig):
        return vision_features(p, images, vision_cfg,
                               compute_dtype=compute_dtype, fold=fold,
                               **lora_kw)
    if lora_kw.get("adapters") is not None:
        raise ValueError("LoRA adapters require a ViT backbone "
                         "(the reference's TTL path is ViT-only)")
    return resnet_features(p, images, vision_cfg, compute_dtype=compute_dtype)


def _pool_eot(x: torch.Tensor, tokens: torch.Tensor, p: Params,
              cfg: TextConfig) -> torch.Tensor:
    """The tower's final norm, the EOT row (the largest id) of every
    prompt, and the f32 projection. x is [N, ctx', D] with N a multiple of
    the C rows of `tokens`: the table repeats along N."""
    x = TEXT_TOWERS[cfg.tower].final_norm(x, p, cfg)
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
    block = TEXT_TOWERS[cfg.tower].block
    x = p["token_embed"][tokens].to(compute_dtype)
    x = x + p["pos_embed"][: x.shape[1]].to(compute_dtype)
    if adapters is None:
        x = _run_layers(p["layers"], x, 0, cfg.layers, block, cfg=cfg)
        return _pool_eot(x, tokens, p, cfg)
    lo, hi = adapter_window
    with torch.no_grad():
        x = _run_layers(p["layers"], x, 0, lo, block, cfg=cfg)
    a = adapters["q"]["A"]
    if a.dim() == 4:
        x = x.repeat(a.shape[0], 1, 1)
    x = _run_layers(p["layers"], x, lo, hi + 1, block, adapters=adapters,
                    lora_scale=lora_scale, cfg=cfg)
    x = _run_layers(p["layers"], x, hi + 1, cfg.layers, block, remat=True,
                    cfg=cfg)
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
    x = _run_layers(p["layers"], x, 0, cfg.layers,
                    TEXT_TOWERS[cfg.tower].block, remat=remat, cfg=cfg)
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
    parameters and logit_scale stay f32, every other leaf is param_dtype;
    a ResNet tower keeps its batchnorms and attention pool in f32
    (`init_resnet_params`); a ViT tower is drawn by its `ViTTower.init`,
    and laid out on a CUDA device by its `card_layout` where it has one;
    the text tower by its `TextTower.init`."""
    v, t = cfg.vision, cfg.text
    if isinstance(v, ResNetVisionConfig):
        vision = init_resnet_params(v, gen, device=device,
                                    param_dtype=param_dtype)
    else:
        tower = TOWERS[v.tower]
        vision = tower.init(gen, v)
        if tower.card_layout and torch.device(device).type == "cuda":
            vision = tower.card_layout(vision, v)
        vision = _placed(vision, device, param_dtype)
    text = TEXT_TOWERS[t.tower].init(gen, t)
    return {"vision": vision,
            "text": _placed(text, device, param_dtype),
            "logit_scale": torch.tensor(math.log(1.0 / 0.07),
                                        dtype=torch.float32, device=device)}


def _init_vit_vision(gen: torch.Generator, v: VisionConfig) -> Params:
    return {
        "patch_embed": _normal(gen, (3 * v.patch * v.patch, v.hidden), 0.02),
        "class_embed": _normal(gen, (v.hidden,), 0.02),
        "pos_embed": _normal(gen, (v.seq_len, v.hidden), 0.02),
        "ln_pre": _init_ln(v.hidden),
        "layers": _init_layers(gen, v.layers, v.hidden, v.mlp_ratio),
        "ln_post": _init_ln(v.hidden),
        "proj": _normal(gen, (v.hidden, v.proj_dim), 0.02),
    }


def _clip_embed(p: Params, images: torch.Tensor, cfg: VisionConfig,
                compute_dtype) -> torch.Tensor:
    return layer_norm(patch_tokens(p, images, cfg, compute_dtype),
                      p["ln_pre"], cfg.ln_eps)


def _clip_block(p: Params, x: torch.Tensor, cfg: VisionConfig,
                **kw) -> torch.Tensor:
    return encoder_layer(p, x, heads=cfg.heads, eps=cfg.ln_eps,
                         causal=False, **kw)


def _clip_head(p: Params, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """ln_post on the class token, then the projection, in f32."""
    return mm_f32(layer_norm(x[:, 0], p["ln_post"], cfg.ln_eps), p["proj"])


def _init_clip_text(gen: torch.Generator, t: TextConfig) -> Params:
    return {
        "token_embed": _normal(gen, (t.vocab, t.hidden), 0.02),
        "pos_embed": _normal(gen, (t.ctx, t.hidden), 0.01),
        "layers": _init_layers(gen, t.layers, t.hidden, t.mlp_ratio),
        "ln_final": _init_ln(t.hidden),
        "proj": _normal(gen, (t.hidden, t.proj_dim), 0.02),
    }


def _clip_text_block(p: Params, x: torch.Tensor, cfg: TextConfig,
                     **kw) -> torch.Tensor:
    return encoder_layer(p, x, heads=cfg.heads, eps=cfg.ln_eps, causal=True,
                         act=cfg.act, **kw)


def _clip_final_norm(x: torch.Tensor, p: Params,
                     cfg: TextConfig) -> torch.Tensor:
    return layer_norm(x, p["ln_final"], cfg.ln_eps)


# every ViT architecture under its VisionConfig.tower, and every text one
# under its TextConfig.tower; a tower's module adds its own rows
# (`models/eva02.py`, `models/aimv2.py`)
TOWERS: Dict[str, ViTTower] = {
    "clip": ViTTower(embed=_clip_embed, block=_clip_block, head=_clip_head,
                     init=_init_vit_vision, remat_window=False, int8=True,
                     converter=True),
}
TEXT_TOWERS: Dict[str, TextTower] = {
    "clip": TextTower(block=_clip_text_block, final_norm=_clip_final_norm,
                      init=_init_clip_text),
}
