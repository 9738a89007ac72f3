"""CLIP in plain float32 PyTorch: the towers, the seeded weights and the
image normalization the reference needs for `"architecture": "clip"` (a
configuration with no `architecture` key is CLIP).

The towers follow the published CLIP ViT (pre-LN blocks, QuickGELU MLP,
class-token pooling, the text tower causal and pooled at its end-of-text
token), with LoRA on q and v of the layers the TTL step adapts. Attention
is an explicit softmax; every product goes through `mm`, which the shared
step (`reference/model.py`) hands in: exact float32, or the float8
control.

The benchmark runs the program with random weights drawn from the run's
seed by the program's own initializer. `draw_weights` draws them again: a
frozen copy of that draw order (one host `torch.Generator` seeded with the
run's seed; every stacked leaf drawn in one call, vision tower first, then
text tower), rounded to the type the configuration serves in and widened
back to float32. Layernorm leaves and the logit scale stay float32, as
served. The adapters are the configuration's LoRA init: A with
Xavier-normal draws from a second generator on the same seed (q's, then
v's), B zero.

Layout: every linear holds `w` as [in, out]; transformer layers are
stacked on a leading axis. The module imports nothing of the program and
nothing of the benchmark; the class prompts are tokenized by the
reference's CLIP BPE (it defines no `prompt_table` of its own).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LN_EPS = 1e-5
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------- towers

def layer_norm(x, p):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]


def _at(stacked, i):
    if isinstance(stacked, dict):
        return {k: _at(v, i) for k, v in stacked.items()}
    return stacked[i]


def attention(q, k, v, heads: int, causal: bool, mm):
    b, s, hd = q.shape
    d = hd // heads

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2)

    scores = mm(split(q), split(k).transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), split(v))
    return out.transpose(1, 2).reshape(b, s, hd)


def _lora(h, ad, scale, n):
    """scale * (h A) B, one adapter set per sample: h [n*V, S, D] split
    into n equal groups, A [n, D, r], B [n, r, D]."""
    hh = h.reshape(n, -1, h.shape[-1])
    return (scale * (hh @ ad["A"]) @ ad["B"]).reshape(h.shape)


def block(p, x, heads: int, causal: bool = False, lora=None,
          scale: float = 2.0, n: int = 1, *, mm):
    h = layer_norm(x, p["ln1"])
    a = p["attn"]
    q = mm(h, a["q"]["w"]) + a["q"]["b"]
    k = mm(h, a["k"]["w"]) + a["k"]["b"]
    v = mm(h, a["v"]["w"]) + a["v"]["b"]
    if lora is not None:
        q = q + _lora(h, lora["q"], scale, n)
        v = v + _lora(h, lora["v"], scale, n)
    x = x + mm(attention(q, k, v, heads, causal, mm), a["o"]["w"]) \
        + a["o"]["b"]
    h = layer_norm(x, p["ln2"])
    m = p["mlp"]
    u = mm(h, m["fc1"]["w"]) + m["fc1"]["b"]
    u = u * torch.sigmoid(1.702 * u)
    return x + mm(u, m["fc2"]["w"]) + m["fc2"]["b"]


def vision_prefix(p, images, vcfg, upto: int, *, mm):
    """Patch embedding and the layers [0, upto): images [B, 3, H, W] ->
    hidden [B, tokens, D]."""
    b = images.shape[0]
    pt = vcfg["patch_size"]
    g = vcfg["image_size"] // pt
    x = images.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = mm(x.reshape(b, g * g, 3 * pt * pt), p["patch_embed"])
    cls = p["class_embed"].expand(b, 1, -1)
    x = layer_norm(torch.cat([cls, x], dim=1) + p["pos_embed"], p["ln_pre"])
    for i in range(upto):
        x = block(_at(p["layers"], i), x, vcfg["num_attention_heads"],
                  mm=mm)
    return x


def vision_rest(p, x, vcfg, lo: int, adapters=None, hi: Optional[int] = None,
                scale: float = 2.0, n: int = 1, *, mm):
    """Layers [lo, end) from a hidden state, LoRA on [lo, hi] where
    `adapters` (leaves [n, L, ...]) are given, then the pooled, projected
    features [B, P]."""
    heads = vcfg["num_attention_heads"]
    for i in range(lo, vcfg["num_hidden_layers"]):
        lora = None
        if adapters is not None and i <= hi:
            lora = {m: {ab: t[:, i - lo] for ab, t in ad.items()}
                    for m, ad in adapters.items()}
        x = block(_at(p["layers"], i), x, heads, lora=lora, scale=scale, n=n,
                  mm=mm)
    return mm(layer_norm(x[:, 0], p["ln_post"]), p["proj"])


def text_classifier(p, tokens, tcfg, batch: int = 250, *, mm):
    """Class features [C, P] of a prompt table [C, 77], not normalized."""
    out = []
    for i in range(0, tokens.shape[0], batch):
        t = tokens[i:i + batch]
        x = p["token_embed"][t] + p["pos_embed"][:t.shape[1]]
        for j in range(tcfg["num_hidden_layers"]):
            x = block(_at(p["layers"], j), x, tcfg["num_attention_heads"],
                      causal=True, mm=mm)
        x = layer_norm(x, p["ln_final"])
        pooled = x[torch.arange(t.shape[0], device=t.device),
                   t.argmax(dim=-1)]
        out.append(mm(pooled, p["proj"]))
    return torch.cat(out)


# --------------------------------------------------------------- weights

def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _ln(shape):
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def _linear(gen, n, d_in, d_out):
    return {"w": _normal(gen, (n, d_in, d_out), 0.02),
            "b": torch.zeros(n, d_out)}


def _layers(gen, n, d, d_mlp):
    return {"ln1": _ln((n, d)), "ln2": _ln((n, d)),
            "attn": {name: _linear(gen, n, d, d) for name in "qkvo"},
            "mlp": {"fc1": _linear(gen, n, d, d_mlp),
                    "fc2": _linear(gen, n, d_mlp, d)}}


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
    v, t = config["vision"], config["text"]
    p = config["projection_dim"]
    gen = torch.Generator().manual_seed(seed)
    grid = v["image_size"] // v["patch_size"]
    d = v["hidden_size"]
    vision = {
        "patch_embed": _normal(gen, (3 * v["patch_size"] ** 2, d), 0.02),
        "class_embed": _normal(gen, (d,), 0.02),
        "pos_embed": _normal(gen, (grid * grid + 1, d), 0.02),
        "ln_pre": _ln(d),
        "layers": _layers(gen, v["num_hidden_layers"], d,
                          v["intermediate_size"]),
        "ln_post": _ln(d),
        "proj": _normal(gen, (d, p), 0.02),
    }
    dt = t["hidden_size"]
    text = {
        "token_embed": _normal(gen, (t["vocab_size"], dt), 0.02),
        "pos_embed": _normal(gen, (t["max_position_embeddings"], dt), 0.01),
        "layers": _layers(gen, t["num_hidden_layers"], dt,
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
