"""EVA02-CLIP in plain float32 PyTorch: the towers, the seeded weights and
the image normalization the reference needs for `"architecture":
"eva02"`.

The vision tower follows EVA-CLIP (arXiv:2303.15389), `eva_vit_model.py`,
as `EVA02-CLIP-L-14-336.json` configures it (`rope`, `intp_freq`,
`naiveswiglu`, `subln`, layernorm eps 1e-6):

- x0 = [cls ; patches W_patch + b_patch] + pos; no layernorm before the
  first layer;
- each layer, pre-LN, with no layer scale and no drop path:
  h = LN1(x); q = h Wq + bq, k = h Wk (no bias), v = h Wv + bv; q and k of
  the patch tokens (not the class token) turned by the 2-D rotary
  embedding (`VisionRotaryEmbeddingFast`: t cos + rot(t) sin, rot taking
  each interleaved pair (a, b) to (-b, a); a head's first half of dims
  carries the patch's row, the second half its column; pair j of a half at
  position p turned by p * (g0 / g) * theta^(-2j / (D/2)), g0 the
  configuration's `rope_pretrain_grid`, g the served grid);
  a = softmax(q k^T / sqrt(d)) v; x = x + LN_attn(a) Wo + bo;
  h = LN2(x); s = SiLU(h W1 + b1) * (h W2 + b2); x = x + LN_ffn(s) W3 + b3,
  LN_ffn over the whole `intermediate_size`;
- features LN_post(x)[:, 0] W_head + b_head.

The text tower is OpenCLIP's `TextTransformer` (EVA-CLIP's
`_build_text_tower`): CLIP's causal pre-LN tower, eps 1e-5, pooled at the
end-of-text token, a bias-free projection, and the exact (erf) GELU, since
EVA-CLIP's configuration does not set `quick_gelu`. LoRA goes on q and v of
the layers the TTL step adapts, q's delta added before the rotary
embedding. Every product goes through `mm`, which the shared step
(`reference/model.py`) hands in: exact float32, or the float8 control.

Departures from the published model and assumptions: the weights are
random (`draw_weights`), not EVA-CLIP's; the rotary tables are computed in
float64 and kept in float32, where EVA computes them in float32 (angles
differ by under 1e-6); attention is an explicit softmax in float32 where
EVA-CLIP uses xformers' memory-efficient kernel; `fusedLN` is a plain
layernorm; the text tower's activation is the code's default, not a key of
the JSON. Image mean and standard deviation are CLIP's (EVA-CLIP's
`OPENAI_DATASET_MEAN`/`_STD`).

`draw_weights` draws the program's initializer again: one host
`torch.Generator` seeded with the run's seed; over the vision tower the
patch embedding, the class and position embeddings, then Wq, Wk, Wv, Wo,
W1, W2, W3 each over all layers in one call, the head, then the biases bq,
bv, bo, b1, b2, b3, the patch bias and the head's bias (every one N(0,
0.02)); then the text tower as CLIP's is drawn. Every leaf but the
layernorms' is rounded to the type the configuration serves in and widened
back to float32. The adapters are the configuration's LoRA init, as for
CLIP. The module imports nothing of the program and nothing of the
benchmark; the class prompts are tokenized by the reference's CLIP BPE.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

VISION_LN_EPS = 1e-6
TEXT_LN_EPS = 1e-5
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------- towers

def layer_norm(x, p, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _at(stacked, i):
    if isinstance(stacked, dict):
        return {k: _at(v, i) for k, v in stacked.items()}
    return stacked[i]


def _split(t, heads):
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2)


def attention(q, k, v, heads: int, causal: bool, mm):
    """q, k, v [B, H, S, d] -> [B, S, H*d]."""
    b, h, s, d = q.shape
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)
    return out.transpose(1, 2).reshape(b, s, h * d)


def rope_tables(vcfg, device):
    """(cos, sin) [grid^2, head_dim] of the patch tokens, row-major."""
    g = vcfg["image_size"] // vcfg["patch_size"]
    d = vcfg["hidden_size"] // vcfg["num_attention_heads"]
    half = d // 2
    f64 = dict(dtype=torch.float64, device=device)
    j = torch.arange(half // 2, **f64)
    freq = vcfg["rope_theta"] ** (-2.0 * j / half)
    pos = torch.arange(g, **f64) * vcfg["rope_pretrain_grid"] / g
    ang = (pos[:, None] * freq[None]).repeat_interleave(2, dim=-1)  # [g, half]
    rows = ang[:, None, :].expand(g, g, half)
    cols = ang[None, :, :].expand(g, g, half)
    ang = torch.cat([rows, cols], dim=-1).reshape(g * g, d)
    return ang.cos().float(), ang.sin().float()


def _rotate(t):
    pairs = t.reshape(*t.shape[:-1], -1, 2)
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)


def apply_rope(t, tables):
    """t [B, H, S, d]: the patch tokens (all but the first) turned."""
    cos, sin = tables
    patches = t[:, :, 1:]
    return torch.cat([t[:, :, :1], patches * cos + _rotate(patches) * sin],
                     dim=2)


def _lora(h, ad, scale, n):
    """scale * (h A) B, one adapter set per sample: h [n*V, S, D] split
    into n equal groups, A [n, D, r], B [n, r, D]."""
    hh = h.reshape(n, -1, h.shape[-1])
    return (scale * (hh @ ad["A"]) @ ad["B"]).reshape(h.shape)


def vision_block(p, x, vcfg, tables, lora=None, scale: float = 2.0,
                 n: int = 1, *, mm):
    heads = vcfg["num_attention_heads"]
    h = layer_norm(x, p["ln1"], VISION_LN_EPS)
    q = mm(h, p["q"]["w"]) + p["q"]["b"]
    k = mm(h, p["k"]["w"])
    v = mm(h, p["v"]["w"]) + p["v"]["b"]
    if lora is not None:
        q = q + _lora(h, lora["q"], scale, n)
        v = v + _lora(h, lora["v"], scale, n)
    q = apply_rope(_split(q, heads), tables)
    k = apply_rope(_split(k, heads), tables)
    a = attention(q, k, _split(v, heads), heads, False, mm)
    x = x + mm(layer_norm(a, p["ln_attn"], VISION_LN_EPS), p["o"]["w"]) \
        + p["o"]["b"]
    h = layer_norm(x, p["ln2"], VISION_LN_EPS)
    u = mm(h, p["w1"]["w"]) + p["w1"]["b"]
    g = mm(h, p["w2"]["w"]) + p["w2"]["b"]
    s = torch.nn.functional.silu(u) * g
    return x + mm(layer_norm(s, p["ln_ffn"], VISION_LN_EPS), p["w3"]["w"]) \
        + p["w3"]["b"]


def vision_prefix(p, images, vcfg, upto: int, *, mm):
    """Patch embedding and the layers [0, upto): images [B, 3, H, W] ->
    hidden [B, tokens, D]."""
    b = images.shape[0]
    pt = vcfg["patch_size"]
    g = vcfg["image_size"] // pt
    x = images.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = mm(x.reshape(b, g * g, 3 * pt * pt), p["patch_embed"]) \
        + p["patch_bias"]
    cls = p["class_embed"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"]
    tables = rope_tables(vcfg, images.device)
    for i in range(upto):
        x = vision_block(_at(p["layers"], i), x, vcfg, tables, mm=mm)
    return x


def vision_rest(p, x, vcfg, lo: int, adapters=None, hi: Optional[int] = None,
                scale: float = 2.0, n: int = 1, *, mm):
    """Layers [lo, end) from a hidden state, LoRA on [lo, hi] where
    `adapters` (leaves [n, L, ...]) are given, then the features [B, P]."""
    tables = rope_tables(vcfg, x.device)
    for i in range(lo, vcfg["num_hidden_layers"]):
        lora = None
        if adapters is not None and i <= hi:
            lora = {m: {ab: t[:, i - lo] for ab, t in ad.items()}
                    for m, ad in adapters.items()}
        x = vision_block(_at(p["layers"], i), x, vcfg, tables, lora=lora,
                         scale=scale, n=n, mm=mm)
    pooled = layer_norm(x[:, 0], p["ln_post"], VISION_LN_EPS)
    return mm(pooled, p["head"]["w"]) + p["head"]["b"]


def text_block(p, x, heads: int, *, mm):
    h = layer_norm(x, p["ln1"], TEXT_LN_EPS)
    a = p["attn"]
    q, k, v = (_split(mm(h, a[n]["w"]) + a[n]["b"], heads) for n in "qkv")
    x = x + mm(attention(q, k, v, heads, True, mm), a["o"]["w"]) \
        + a["o"]["b"]
    h = layer_norm(x, p["ln2"], TEXT_LN_EPS)
    m = p["mlp"]
    u = torch.nn.functional.gelu(mm(h, m["fc1"]["w"]) + m["fc1"]["b"])
    return x + mm(u, m["fc2"]["w"]) + m["fc2"]["b"]


def text_classifier(p, tokens, tcfg, batch: int = 250, *, mm):
    """Class features [C, P] of a prompt table [C, 77], not normalized."""
    out = []
    for i in range(0, tokens.shape[0], batch):
        t = tokens[i:i + batch]
        x = p["token_embed"][t] + p["pos_embed"][:t.shape[1]]
        for j in range(tcfg["num_hidden_layers"]):
            x = text_block(_at(p["layers"], j), x,
                           tcfg["num_attention_heads"], mm=mm)
        x = layer_norm(x, p["ln_final"], TEXT_LN_EPS)
        pooled = x[torch.arange(t.shape[0], device=t.device),
                   t.argmax(dim=-1)]
        out.append(mm(pooled, p["proj"]))
    return torch.cat(out)


# --------------------------------------------------------------- weights

def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _ln(shape):
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def _text_layers(gen, n, d, d_mlp):
    def linear(d_in, d_out):
        return {"w": _normal(gen, (n, d_in, d_out), 0.02),
                "b": torch.zeros(n, d_out)}
    attn = {name: linear(d, d) for name in "qkvo"}
    mlp = {"fc1": linear(d, d_mlp), "fc2": linear(d_mlp, d)}
    return {"ln1": _ln((n, d)), "ln2": _ln((n, d)), "attn": attn,
            "mlp": mlp}


def _vision(gen, v, p):
    n, d, f = v["num_hidden_layers"], v["hidden_size"], v["intermediate_size"]
    grid = v["image_size"] // v["patch_size"]
    patch = _normal(gen, (3 * v["patch_size"] ** 2, d), 0.02)
    cls = _normal(gen, (d,), 0.02)
    pos = _normal(gen, (grid * grid + 1, d), 0.02)
    w = {name: _normal(gen, (n, d_in, d_out), 0.02)
         for name, d_in, d_out in (("q", d, d), ("k", d, d), ("v", d, d),
                                   ("o", d, d), ("w1", d, f), ("w2", d, f),
                                   ("w3", f, d))}
    head = _normal(gen, (d, p), 0.02)
    b = {name: _normal(gen, (n, width), 0.02)
         for name, width in (("q", d), ("v", d), ("o", d), ("w1", f),
                             ("w2", f), ("w3", d))}
    layers = {name: {"w": w[name], "b": b[name]}
              for name in ("q", "v", "o", "w1", "w2", "w3")}
    layers["k"] = {"w": w["k"]}
    layers.update(ln1=_ln((n, d)), ln_attn=_ln((n, d)), ln2=_ln((n, d)),
                  ln_ffn=_ln((n, f)))
    return {"patch_embed": patch, "patch_bias": _normal(gen, (d,), 0.02),
            "class_embed": cls, "pos_embed": pos, "layers": layers,
            "ln_post": _ln(d),
            "head": {"w": head, "b": _normal(gen, (p,), 0.02)}}


def _served(tree, dtype, in_ln=False):
    """Round every leaf but the layernorms' to the served type, then widen
    to float32 for the reference's arithmetic."""
    if isinstance(tree, dict):
        return {k: _served(v, dtype, in_ln or k.startswith("ln"))
                for k, v in tree.items()}
    return tree if in_ln else tree.to(dtype).float()


def draw_weights(config: dict, seed: int) -> dict:
    """The float32 weights the program serves for `seed` under `config`
    (a configuration file of the benchmark), on the host."""
    t = config["text"]
    p = config["projection_dim"]
    gen = torch.Generator().manual_seed(seed)
    vision = _vision(gen, config["vision"], p)
    dt = t["hidden_size"]
    text = {
        "token_embed": _normal(gen, (t["vocab_size"], dt), 0.02),
        "pos_embed": _normal(gen, (t["max_position_embeddings"], dt), 0.01),
        "layers": _text_layers(gen, t["num_hidden_layers"], dt,
                               t["intermediate_size"]),
        "ln_final": _ln(dt),
        "proj": _normal(gen, (dt, p), 0.02),
    }
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
