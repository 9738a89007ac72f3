"""AIMv2-L/14 LiT in plain float32 PyTorch: the towers, the seeded weights
and the image normalization the reference needs for `"architecture":
"lit_aimv2"` (AIMv2's image tower with its LiT text tower).

The towers follow AIMv2 (arXiv:2411.14402) as transformers 4.57's
`models/aimv2/modeling_aimv2.py` writes them for
`apple/aimv2-large-patch14-224-lit` (`Aimv2VisionModel` with `use_head`,
`is_native` false; `Aimv2TextModel`; `Aimv2Model`'s projections), with the
shapes of `configuration_aimv2.py`'s defaults, which its docstrings tie to
that checkpoint:

- RMSNorm(x) = w * x / sqrt(mean(x^2) + eps), eps `rms_norm_eps` (1e-5),
  no mean subtraction and no bias;
- vision: x0 = RMSNorm_e(conv(img) + b_patch) + pos, the patch convolution
  written as the product of the flattened patches, pos a learned [g^2, D]
  table, no class token and no norm before the first layer;
- each layer of either tower, pre-norm, with no bias in any linear
  (`qkv_bias`, `mlp_bias` false): h = RMSNorm_1(x); q, k, v = h Wq, h Wk,
  h Wv; a = softmax(q k^T / sqrt(d)) v (causal in the text tower);
  x = x + a Wo; h = RMSNorm_2(x); x = x + (SiLU(h Wg) * (h Wu)) Wd;
- vision head (`Aimv2AttentionPoolingHead`): y = RMSNorm_f(x) over every
  token; one learned query c [D] split into the heads with no projection;
  k = y Wk', v = y Wv' (no bias); p = softmax(c k^T / sqrt(d)) v; then
  (p Wout + b_out) Wproj, Wproj the bias-free `visual_projection`;
- text: token and learned position embeddings, the layers, a final
  RMSNorm, the row at the first end-of-text token (49407, the largest id of
  CLIP's BPE), the bias-free `text_projection`.

LoRA goes on q and v of the layers the TTL step adapts. Every product goes
through `mm`, which the shared step (`reference/model.py`) hands in: exact
float32, or the float8 control.

Departures from the published model and assumptions: the weights are
random (`draw_weights`), not AIMv2's; the text tower is causal, which
transformers makes it only where an attention mask is passed (its
`create_causal_mask`), as AIMv2's processor always passes one; attention is
an explicit softmax in float32 where transformers calls SDPA; the logit
scale is ln(1/0.07), below the checkpoint's clamp at ln(100); the RMSNorm
multiplies by its weight in float32, where transformers rounds x * rstd to
the input type first (the reference computes in float32 throughout, so
the two agree here). Image mean and standard deviation are CLIP's.

`draw_weights` draws the program's initializer again: one host
`torch.Generator` seeded with the run's seed; over the vision tower the
patch embedding, the position embedding, then Wq, Wk, Wv, Wo, Wg, Wu, Wd
each over all layers in one call, the pooling query, Wk', Wv', Wout, the
projection, then the biases b_patch and b_out (every one N(0, 0.02)); then
the text tower: token embedding N(0, 0.02), position embedding N(0, 0.01),
Wq .. Wd as the vision tower's, the projection N(0, 0.02). RMSNorm weights
are 1. Every leaf but the norms' is rounded to the type the configuration
serves in and widened back to float32. The adapters are the configuration's
LoRA init, as for CLIP. The module imports nothing of the program and
nothing of the benchmark; the class prompts are tokenized by the
reference's CLIP BPE.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------- towers

def rms_norm(x, p, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * p["scale"]


def _at(stacked, i):
    if isinstance(stacked, dict):
        return {k: _at(v, i) for k, v in stacked.items()}
    return stacked[i]


def _split(t, heads):
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2)


def attention(q, k, v, causal: bool, mm):
    """q [B, H, Sq, d], k, v [B, H, S, d] -> [B, Sq, H*d]."""
    b, h, sq, d = q.shape
    s = k.shape[2]
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)
    return out.transpose(1, 2).reshape(b, sq, h * d)


def _lora(h, ad, scale, n):
    """scale * (h A) B, one adapter set per sample: h [n*V, S, D] split
    into n equal groups, A [n, D, r], B [n, r, D]."""
    hh = h.reshape(n, -1, h.shape[-1])
    return (scale * (hh @ ad["A"]) @ ad["B"]).reshape(h.shape)


def block(p, x, heads: int, eps: float, causal: bool, lora=None,
          scale: float = 2.0, n: int = 1, *, mm):
    h = rms_norm(x, p["ln1"], eps)
    q, k, v = (mm(h, p[name]["w"]) for name in "qkv")
    if lora is not None:
        q = q + _lora(h, lora["q"], scale, n)
        v = v + _lora(h, lora["v"], scale, n)
    a = attention(_split(q, heads), _split(k, heads), _split(v, heads),
                  causal, mm)
    x = x + mm(a, p["o"]["w"])
    h = rms_norm(x, p["ln2"], eps)
    s = torch.nn.functional.silu(mm(h, p["wg"]["w"])) * mm(h, p["wu"]["w"])
    return x + mm(s, p["wd"]["w"])


def vision_prefix(p, images, vcfg, upto: int, *, mm):
    """Patch embedding and the layers [0, upto): images [B, 3, H, W] ->
    hidden [B, tokens, D]."""
    b = images.shape[0]
    pt = vcfg["patch_size"]
    g = vcfg["image_size"] // pt
    eps = vcfg["rms_norm_eps"]
    x = images.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = mm(x.reshape(b, g * g, 3 * pt * pt), p["patch_embed"]) \
        + p["patch_bias"]
    x = rms_norm(x, p["ln_embed"], eps) + p["pos_embed"]
    for i in range(upto):
        x = block(_at(p["layers"], i), x, vcfg["num_attention_heads"], eps,
                  False, mm=mm)
    return x


def pool(p, x, vcfg, *, mm):
    """The attention-pooling head and the projection: [B, S, D] -> [B, P]."""
    b, s, d = x.shape
    heads = vcfg["num_attention_heads"]
    y = rms_norm(x, p["ln_post"], vcfg["rms_norm_eps"])
    k = _split(mm(y, p["pool_k"]["w"]), heads)
    v = _split(mm(y, p["pool_v"]["w"]), heads)
    q = p["pool_query"].reshape(1, heads, 1, d // heads).expand(b, -1, -1,
                                                                -1)
    pooled = attention(q, k, v, False, mm)[:, 0]
    return mm(mm(pooled, p["pool_out"]["w"]) + p["pool_out"]["b"], p["proj"])


def vision_rest(p, x, vcfg, lo: int, adapters=None, hi: Optional[int] = None,
                scale: float = 2.0, n: int = 1, *, mm):
    """Layers [lo, end) from a hidden state, LoRA on [lo, hi] where
    `adapters` (leaves [n, L, ...]) are given, then the features [B, P]."""
    for i in range(lo, vcfg["num_hidden_layers"]):
        lora = None
        if adapters is not None and i <= hi:
            lora = {m: {ab: t[:, i - lo] for ab, t in ad.items()}
                    for m, ad in adapters.items()}
        x = block(_at(p["layers"], i), x, vcfg["num_attention_heads"],
                  vcfg["rms_norm_eps"], False, lora=lora, scale=scale, n=n,
                  mm=mm)
    return pool(p, x, vcfg, mm=mm)


def text_classifier(p, tokens, tcfg, batch: int = 250, *, mm):
    """Class features [C, P] of a prompt table [C, 77], not normalized."""
    out = []
    eps = tcfg["rms_norm_eps"]
    for i in range(0, tokens.shape[0], batch):
        t = tokens[i:i + batch]
        x = p["token_embed"][t] + p["pos_embed"][:t.shape[1]]
        for j in range(tcfg["num_hidden_layers"]):
            x = block(_at(p["layers"], j), x, tcfg["num_attention_heads"],
                      eps, True, mm=mm)
        x = rms_norm(x, p["ln_final"], eps)
        pooled = x[torch.arange(t.shape[0], device=t.device),
                   t.argmax(dim=-1)]
        out.append(mm(pooled, p["proj"]))
    return torch.cat(out)


# --------------------------------------------------------------- weights

def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _layers(gen, n, d, f):
    w = {name: _normal(gen, (n, d_in, d_out), 0.02)
         for name, d_in, d_out in (("q", d, d), ("k", d, d), ("v", d, d),
                                   ("o", d, d), ("wg", d, f), ("wu", d, f),
                                   ("wd", f, d))}
    layers = {name: {"w": t} for name, t in w.items()}
    layers.update(ln1={"scale": torch.ones(n, d)},
                  ln2={"scale": torch.ones(n, d)})
    return layers


def _vision(gen, v, p):
    n, d = v["num_hidden_layers"], v["hidden_size"]
    grid = v["image_size"] // v["patch_size"]
    patch = _normal(gen, (3 * v["patch_size"] ** 2, d), 0.02)
    pos = _normal(gen, (grid * grid, d), 0.02)
    layers = _layers(gen, n, d, v["intermediate_size"])
    query = _normal(gen, (d,), 0.02)
    wk, wv, wout = (_normal(gen, (d, d), 0.02) for _ in range(3))
    proj = _normal(gen, (d, p), 0.02)
    return {"patch_embed": patch, "patch_bias": _normal(gen, (d,), 0.02),
            "ln_embed": {"scale": torch.ones(d)}, "pos_embed": pos,
            "layers": layers, "ln_post": {"scale": torch.ones(d)},
            "pool_query": query, "pool_k": {"w": wk}, "pool_v": {"w": wv},
            "pool_out": {"w": wout, "b": _normal(gen, (d,), 0.02)},
            "proj": proj}


def _text(gen, t, p):
    d = t["hidden_size"]
    token = _normal(gen, (t["vocab_size"], d), 0.02)
    pos = _normal(gen, (t["max_position_embeddings"], d), 0.01)
    layers = _layers(gen, t["num_hidden_layers"], d, t["intermediate_size"])
    return {"token_embed": token, "pos_embed": pos, "layers": layers,
            "ln_final": {"scale": torch.ones(d)},
            "proj": _normal(gen, (d, p), 0.02)}


def _served(tree, dtype, in_ln=False):
    """Round every leaf but the norms' to the served type, then widen to
    float32 for the reference's arithmetic."""
    if isinstance(tree, dict):
        return {k: _served(v, dtype, in_ln or k.startswith("ln"))
                for k, v in tree.items()}
    return tree if in_ln else tree.to(dtype).float()


def draw_weights(config: dict, seed: int) -> dict:
    """The float32 weights the program serves for `seed` under `config`
    (a configuration file of the benchmark), on the host."""
    p = config["projection_dim"]
    gen = torch.Generator().manual_seed(seed)
    vision = _vision(gen, config["vision"], p)
    text = _text(gen, config["text"], p)
    dtype = DTYPES[config["ttl"]["param_dtype"]]
    return {"vision": _served(vision, dtype), "text": _served(text, dtype),
            "logit_scale": torch.tensor(config["logit_scale_init"],
                                        dtype=torch.float32)}


def draw_adapters(config: dict, seed: int) -> dict:
    """Fresh LoRA adapters of the configuration's window: A [L, D, r]
    Xavier-normal, B [L, r, D] zero, for q and v."""
    ttl = config["ttl"]
    lo, hi = ttl["lora_layers"]
    d, r = config["vision"]["hidden_size"], ttl["lora_rank"]
    if ttl["lora_init"] != "xavier":
        raise ValueError(f"lora_init {ttl['lora_init']!r}: the reference "
                         "draws xavier only")
    gen = torch.Generator().manual_seed(seed)
    shape = (hi - lo + 1, d, r)
    std = math.sqrt(2.0 / (d + r))
    a_q = torch.randn(shape, generator=gen) * std
    a_v = torch.randn(shape, generator=gen) * std
    zero = torch.zeros(hi - lo + 1, r, d)
    return {"q": {"A": a_q, "B": zero}, "v": {"A": a_v, "B": zero.clone()}}
