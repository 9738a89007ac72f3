"""CLIP's towers and the TTL step in plain float32 PyTorch.

The reference the benchmark judges the program's answers against. It
follows the published CLIP ViT (pre-LN blocks, QuickGELU MLP, class-token
pooling, the text tower causal and pooled at its end-of-text token) and the
TTL paper's test-time step (arXiv:2407.15913): LoRA on q and v of the last
layers, the DeYO-reweighted entropy over the image's views, one AdamW step,
then the clean view classified with the adapted weights; beside it the
clean view's zero-shot logits. Everything runs in float32 with TF32 off;
attention is an explicit softmax. It imports nothing of the program under
test.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LN_EPS = 1e-5
KEEP_ENTROPY = math.log(1000.0)


def exact(a, b):
    """a @ b in float32."""
    return a @ b


def _fp8(t):
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude at the format's largest, 448); the gradient passes as if
    unrounded."""
    x = t.detach()
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    rounded = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - x)


def fp8(a, b):
    """a @ b with both operands rounded to float8 e4m3 first: the control,
    a step below the bfloat16 the configuration computes in."""
    return _fp8(a) @ _fp8(b)


def f32_products() -> None:
    """Full float32 products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, p):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]


def _at(stacked, i):
    if isinstance(stacked, dict):
        return {k: _at(v, i) for k, v in stacked.items()}
    return stacked[i]


def attention(q, k, v, heads: int, causal: bool, mm=exact):
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
          scale: float = 2.0, n: int = 1, mm=exact):
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


def vision_prefix(p, images, vcfg, upto: int, mm=exact):
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
                scale: float = 2.0, n: int = 1, mm=exact):
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


def text_classifier(p, tokens, tcfg, batch: int = 250, mm=exact):
    """L2-normalized class features [C, P] of a prompt table [C, 77]."""
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
    return normalize(torch.cat(out))


def normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def classify(params, feats, classes):
    return torch.exp(params["logit_scale"]) * normalize(feats) @ classes.T


def deyo_loss(logits, e0: float):
    """DeYO's reweighted entropy of each sample's views: logits [n, V, C]
    -> [n]. Views above log(1000) nats are dropped; a sample that keeps
    none has loss 0 and is not updated."""
    logp = torch.log_softmax(logits, dim=-1)
    ent = -(logp.exp() * logp).sum(dim=-1)
    keep = (ent <= KEEP_ENTROPY).float()
    coeff = torch.exp(-(ent.detach() - e0))
    kept = keep.sum(dim=-1)
    loss = (ent * coeff * keep).sum(dim=-1) / kept.clamp(min=1.0)
    return torch.where(kept > 0, loss, torch.zeros_like(loss)), kept > 0


def adamw_first_step(leaf, grad, ttl, do):
    """One AdamW step from a fresh state, where `do` [n] is set."""
    b1, b2 = ttl["betas"]
    m_hat = (1 - b1) * grad / (1 - b1)
    v_hat = (1 - b2) * grad * grad / (1 - b2)
    update = m_hat / (torch.sqrt(v_hat) + ttl["eps"]) \
        + ttl["weight_decay"] * leaf
    do = do.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(do, leaf - ttl["lr"] * update, leaf)


def ttl_logits(params, config, views, classes, adapters0, mm=exact):
    """The adapted clean-view logits [n, C] and the zero-shot clean-view
    logits [n, C] of n images, each from its views [n, V, 3, H, W]: one
    DeYO step on the LoRA adapters per image, from fresh state."""
    vcfg, ttl = config["vision"], config["ttl"]
    lo, hi = ttl["lora_layers"]
    scale = ttl["lora_alpha"] / ttl["lora_rank"]
    if ttl["steps"] != 1:
        raise ValueError("the reference takes one adaptation step")
    n, v = views.shape[:2]
    vp = params["vision"]
    with torch.no_grad():
        hidden = vision_prefix(vp, views.flatten(0, 1), vcfg, lo, mm)
    leaves = {m: {ab: t.expand(n, *t.shape).clone().requires_grad_(True)
                  for ab, t in ad.items()} for m, ad in adapters0.items()}
    with torch.enable_grad():
        feats = vision_rest(vp, hidden, vcfg, lo, leaves, hi, scale, n, mm)
        logits = classify(params, feats, classes).reshape(n, v, -1)
        loss, do = deyo_loss(logits, ttl["deyo_margin_e0"])
        flat = [leaves[m][ab] for m in ("q", "v") for ab in ("A", "B")]
        grads = torch.autograd.grad(loss.sum(), flat)
    with torch.no_grad():
        stepped = [adamw_first_step(t.detach(), g, ttl, do)
                   for t, g in zip(flat, grads)]
        adapted = {"q": {"A": stepped[0], "B": stepped[1]},
                   "v": {"A": stepped[2], "B": stepped[3]}}
        clean = hidden.reshape(n, v, *hidden.shape[1:])[:, 0]
        out = classify(params, vision_rest(vp, clean, vcfg, lo, adapted, hi,
                                           scale, n, mm), classes)
        zero_shot = classify(params, vision_rest(vp, clean, vcfg, lo, mm=mm),
                             classes)
    return out, zero_shot
