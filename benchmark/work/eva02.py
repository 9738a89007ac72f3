"""The work of EVA02's adapted step, from the configuration's shapes
(`"architecture": "eva02"`). `harness/work.py` calls `layer_flops`,
`image_flops` and `attention_calls`; the `swiglu_roofline` reader calls
`swiglu_calls`.

A layer has q, k, v and o (four d x d linears), the SwiGLU MLP's W1, W2
(d -> F) and W3 (F -> d), and attention's 4 x S^2 x d, at S = grid^2 + 1
tokens: 2 x (4 d^2 + 3 d F) + 4 S d a token, 27.5 MFLOP at L/14@336 (d =
1024, F = 2730, S = 577). The layernorms, RoPE and SwiGLU's elementwise
work are not counted, as CLIP's QuickGELU is not. An adapted image counts
as CLIP's (`work/clip.py`):

  image = views x (prefix + window) forward
        + 1.07 x the window forward (the activation-grad backward)
        + views x patch embedding + one clean view through the window,
          adapted, and one more without adapters (the zero-shot aux pass)

about 27.8 TFLOP at L/14@336 with 64 views and LoRA on the last three
layers. The attention calls are listed as (batch, tokens, heads,
head_dim); the SwiGLU launches as bytes, each value read once and each
written once (forward [u | g] in, SiLU(u) g out: 3F a row; backward [u |
g] and dy in, [du | dg] out: 5F a row), over the true S tokens of every
sequence: padding is the program's choice, not work, and so is running a
layer's forward again in its backward (recomputation), which these counts
leave out.
"""
from __future__ import annotations

BYTES = {"bfloat16": 2, "float32": 4}


def _vision(config: dict):
    v = config["vision"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return v, tokens


def layer_flops(config: dict) -> float:
    """One view through one vision layer."""
    v, s = _vision(config)
    d, ff = v["hidden_size"], v["intermediate_size"]
    return s * (2 * (4 * d * d + 3 * d * ff) + 4 * s * d)


def patch_flops(config: dict) -> float:
    v, s = _vision(config)
    return 2 * (s - 1) * 3 * v["patch_size"] ** 2 * v["hidden_size"]


def image_flops(config: dict) -> float:
    """Model FLOPs of one adapted image on the served path."""
    v = config["vision"]
    layer = layer_flops(config)
    views = config["ttl"]["views"]
    window = v["num_hidden_layers"] - config["ttl"]["lora_layers"][0]
    return (views * v["num_hidden_layers"] * layer
            + 1.07 * views * window * layer
            + views * patch_flops(config)
            + 2 * window * layer)


def _sequences(config: dict, images: int):
    """(forward, backward) launches of a step over `images` images, each
    as the number of sequences it covers: every view through every layer,
    the window's backward over every view, the clean view through the
    window twice (adapted, zero-shot)."""
    v = config["vision"]
    views = config["ttl"]["views"]
    layers = v["num_hidden_layers"]
    window = layers - config["ttl"]["lora_layers"][0]
    fwd = [images * views] * layers + [images] * (2 * window)
    return fwd, [images * views] * window


def attention_calls(config: dict, images: int):
    """(forward calls, backward calls) of one adapted step over `images`
    images."""
    v, s = _vision(config)
    heads = v["num_attention_heads"]
    hd = v["hidden_size"] // heads
    fwd, bwd = _sequences(config, images)
    return ([(b, s, heads, hd) for b in fwd],
            [(b, s, heads, hd) for b in bwd])


def swiglu_calls(config: dict, images: int):
    """The bytes of each SwiGLU launch of one adapted step over `images`
    images: forwards first, then backwards."""
    v, s = _vision(config)
    row = v["intermediate_size"] * BYTES[config["ttl"]["compute_dtype"]]
    fwd, bwd = _sequences(config, images)
    return [b * s * 3 * row for b in fwd] + [b * s * 5 * row for b in bwd]
