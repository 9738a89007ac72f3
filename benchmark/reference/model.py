"""The TTL step in plain float32 PyTorch, shared by every architecture.

The reference the benchmark judges the program's answers against. It
follows the TTL paper's test-time step (arXiv:2407.15913): LoRA adapters
on the last layers, the DeYO-reweighted entropy over the image's views,
one AdamW step, then the clean view classified with the adapted weights;
beside it the clean view's zero-shot logits. Everything runs in float32
with TF32 off. It imports nothing of the program under test.

What differs between architectures is a module of its own
(`reference/arch/<name>.py`, found by the configuration's `architecture`
key), handed to `ttl_logits` as `arch`:

- `vision_prefix(p, images, vcfg, upto, mm=)`: images [B, 3, H, W] ->
  hidden [B, tokens, D] through the layers below the LoRA window;
- `vision_rest(p, hidden, vcfg, lo, adapters, hi, scale, n, mm=)`: the
  layers from `lo` on, LoRA on [lo, hi] where adapters (leaves [n, L, ...])
  are given, to the pooled, projected features [B, P];
- `text_classifier(p, tokens, tcfg, mm=)`: class features [C, P];
- `draw_weights(config, seed)`: {"vision", "text", "logit_scale"}, float32
  on the host, drawn in the program's order; `draw_adapters(config,
  seed)`: {target: {"A", "B"}} leaves [L, ...];
- `IMAGE_MEAN`, `IMAGE_STD`; optionally `prompt_table(classnames,
  template)` (the CLIP BPE's by default).

Every product goes through `mm`: `exact`, or `fp8` for the control.
"""
from __future__ import annotations

import math

import torch

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


def ttl_logits(arch, params, config, views, classes, adapters0, mm=exact):
    """The adapted clean-view logits [n, C] and the zero-shot clean-view
    logits [n, C] of n images, each from its views [n, V, 3, H, W]: one
    DeYO step on the LoRA adapters per image, from fresh state. `classes`
    are the L2-normalized class features [C, P]."""
    vcfg, ttl = config["vision"], config["ttl"]
    lo, hi = ttl["lora_layers"]
    scale = ttl["lora_alpha"] / ttl["lora_rank"]
    if ttl["steps"] != 1:
        raise ValueError("the reference takes one adaptation step")
    n, v = views.shape[:2]
    vp = params["vision"]
    with torch.no_grad():
        hidden = arch.vision_prefix(vp, views.flatten(0, 1), vcfg, lo, mm=mm)
    leaves = {m: {ab: t.expand(n, *t.shape).clone().requires_grad_(True)
                  for ab, t in ad.items()} for m, ad in adapters0.items()}
    names = [(m, ab) for m, ad in leaves.items() for ab in ad]
    with torch.enable_grad():
        feats = arch.vision_rest(vp, hidden, vcfg, lo, leaves, hi, scale, n,
                                 mm=mm)
        logits = classify(params, feats, classes).reshape(n, v, -1)
        loss, do = deyo_loss(logits, ttl["deyo_margin_e0"])
        grads = torch.autograd.grad(loss.sum(),
                                    [leaves[m][ab] for m, ab in names])
    with torch.no_grad():
        adapted = {m: {} for m in leaves}
        for (m, ab), g in zip(names, grads):
            adapted[m][ab] = adamw_first_step(leaves[m][ab].detach(), g, ttl,
                                              do)
        clean = hidden.reshape(n, v, *hidden.shape[1:])[:, 0]
        out = classify(params, arch.vision_rest(vp, clean, vcfg, lo, adapted,
                                                hi, scale, n, mm=mm),
                       classes)
        zero_shot = classify(params, arch.vision_rest(vp, clean, vcfg, lo,
                                                      mm=mm), classes)
    return out, zero_shot
