"""The work of AIMv2's adapted step, from the configuration's shapes
(`"architecture": "lit_aimv2"`). `harness/work.py` calls `layer_flops`,
`image_flops` and `attention_calls`; the `swiglu_roofline` reader calls
`swiglu_calls` and the `rms_norm_roofline` reader `rms_norm_calls`.

A layer has q, k, v and o (four d x d linears), the SwiGLU MLP's Wg, Wu
(d -> F) and Wd (F -> d), and attention's 4 x S^2 x d, at S = grid^2 tokens
(no class token): 2 x (4 d^2 + 3 d F) + 4 S d a token, 26.7 MFLOP at L/14
(d = 1024, F = 2816, S = 256). The pooling head of a view is the k/v
product over every token (2 x S x d x 2d), the single query's scores and
weighted sum (4 S d), Wout (2 d^2) and the projection (2 d P). The norms
and SwiGLU's elementwise work are not counted, as CLIP's QuickGELU is not.
An adapted image counts as CLIP's (`work/clip.py`), with the head beside
the window:

  image = views x (every layer + the head) forward
        + 1.07 x (the window + the head) forward (the activation-grad
          backward)
        + views x patch embedding + one clean view through the window and
          the head, adapted, and one more without adapters (the zero-shot
          aux pass)

about 12.1 TFLOP at L/14 with 64 views and LoRA on the last three layers.
The attention calls are listed as (batch, tokens, heads, head_dim); the
SwiGLU launches as bytes, each value read once and each written once
(forward [g | u] in, SiLU(g) u out: 3F a row; backward [g | u] and dy in,
[dg | du] out: 5F a row); the RMS launches of the layernorm kernel as bytes
too (forward x in, y out: 2d a row; dx backward x and dy in, dx out: 3d a
row). Every count is over the true S tokens of every sequence.

The RMS launches of a step: RMSNorm_e once over every view (the frozen
prefix folds its RMSNorm_1 and RMSNorm_2 into K6, which these do not
count); in each window layer RMSNorm_1 and RMSNorm_2 forward over every
view, and their dx backward, but for the first window layer's RMSNorm_1,
whose input (the frozen prefix's output) takes no gradient; RMSNorm_f
forward and backward over every view; then the clean view's two passes
through the window and the head, forward.
"""
from __future__ import annotations

BYTES = {"bfloat16": 2, "float32": 4}


def _vision(config: dict):
    v = config["vision"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2
    return v, tokens


def _window(config: dict) -> int:
    v = config["vision"]
    return v["num_hidden_layers"] - config["ttl"]["lora_layers"][0]


def layer_flops(config: dict) -> float:
    """One view through one vision layer."""
    v, s = _vision(config)
    d, ff = v["hidden_size"], v["intermediate_size"]
    return s * (2 * (4 * d * d + 3 * d * ff) + 4 * s * d)


def head_flops(config: dict) -> float:
    """One view through the pooling head and the projection."""
    v, s = _vision(config)
    d = v["hidden_size"]
    return (2 * s * d * 2 * d + 4 * s * d + 2 * d * d
            + 2 * d * config["projection_dim"])


def patch_flops(config: dict) -> float:
    v, s = _vision(config)
    return 2 * s * 3 * v["patch_size"] ** 2 * v["hidden_size"]


def image_flops(config: dict) -> float:
    """Model FLOPs of one adapted image on the served path."""
    v = config["vision"]
    layer, head = layer_flops(config), head_flops(config)
    views = config["ttl"]["views"]
    window = _window(config)
    return (views * (v["num_hidden_layers"] * layer + head)
            + 1.07 * views * (window * layer + head)
            + views * patch_flops(config)
            + 2 * (window * layer + head))


def _sequences(config: dict, images: int):
    """(forward, backward) launches of a step's layers over `images`
    images, each as the number of sequences it covers: every view through
    every layer, the window's backward over every view, the clean view
    through the window twice (adapted, zero-shot)."""
    views = config["ttl"]["views"]
    layers = config["vision"]["num_hidden_layers"]
    window = _window(config)
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


def rms_norm_calls(config: dict, images: int):
    """The bytes of each RMS launch of the layernorm kernel in one adapted
    step over `images` images (see the module): forwards first, then dx
    backwards."""
    v, s = _vision(config)
    row = v["hidden_size"] * BYTES[config["ttl"]["compute_dtype"]]
    views = images * config["ttl"]["views"]
    window = _window(config)
    fwd = [views] * (1 + 2 * window + 1) + [images] * 2 * (2 * window + 1)
    bwd = [views] * (2 * window - 1 + 1)
    return [b * s * 2 * row for b in fwd] + [b * s * 3 * row for b in bwd]
