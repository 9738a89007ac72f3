"""The work of CLIP's adapted step, from the configuration's shapes
(`"architecture": "clip"`). `harness/work.py` calls `layer_flops`,
`image_flops` and `attention_calls`.

The model FLOPs of an image follow the program's ceiling accounting (each
linear 2 x in x out a token, attention 4 x S^2 x D a layer and view):

  image = views x (prefix + window) forward
        + 1.07 x the window forward (the activation-grad backward; the
          tower is frozen, LoRA's products are noise)
        + views x patch embedding + one clean view through the window,
          adapted, and one more without adapters (the zero-shot aux pass
          of `predict` and `serve`)

which gives 1.675 TFLOP for ViT-B/16's 9-layer, 64-view prefix. A layer
has four d x d linears (q, k, v, o) and the two of the QuickGELU MLP, at S
= grid^2 + 1 tokens (the class token). The attention calls are listed as
(batch, tokens, heads, head_dim), S the true token count.
"""
from __future__ import annotations


def _vision(config: dict):
    v = config["vision"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return v, tokens


def layer_flops(config: dict) -> float:
    """One view through one vision layer."""
    v, s = _vision(config)
    d, ff = v["hidden_size"], v["intermediate_size"]
    return 2 * s * (4 * d * d + 2 * d * ff) + 4 * s * s * d


def patch_flops(config: dict) -> float:
    v, s = _vision(config)
    return 2 * (s - 1) * 3 * v["patch_size"] ** 2 * v["hidden_size"]


def image_flops(config: dict) -> float:
    """Model FLOPs of one adapted image on the served path."""
    v = config["vision"]
    layer = layer_flops(config)
    views = config["ttl"]["views"]
    lo = config["ttl"]["lora_layers"][0]
    window = v["num_hidden_layers"] - lo
    return (views * v["num_hidden_layers"] * layer
            + 1.07 * views * window * layer
            + views * patch_flops(config)
            + 2 * window * layer)


def attention_calls(config: dict, images: int):
    """(forward calls, backward calls) of one adapted step over `images`
    images: every view through every layer, the window's backward, and the
    clean view through the window twice (adapted, zero-shot)."""
    v, s = _vision(config)
    heads = v["num_attention_heads"]
    hd = v["hidden_size"] // heads
    layers = v["num_hidden_layers"]
    views = config["ttl"]["views"]
    window = layers - config["ttl"]["lora_layers"][0]
    fwd = [(images * views, s, heads, hd)] * layers \
        + [(images, s, heads, hd)] * (2 * window)
    bwd = [(images * views, s, heads, hd)] * window
    return fwd, bwd
