"""Operation and byte counts of the work a step must do, from the shapes.

The model FLOPs of an image follow the program's ceiling accounting (each
linear 2 x in x out a token, attention 4 x S^2 x D a layer and view):

  image = views x (prefix + window) forward
        + 1.07 x the window forward (the activation-grad backward; the
          tower is frozen, LoRA's products are noise)
        + views x patch embedding + one clean view through the window,
          adapted, and one more without adapters (the zero-shot aux pass
          of `predict` and `serve`)

which gives 1.675 TFLOP for ViT-B/16's 9-layer, 64-view prefix.

The attention calls of a step are listed with their shapes, for the
kernels' rooflines: forward, q, k and v read once and o written once, 4 x
S^2 x D FLOPs a head; backward, q, k, v and dO read once and dq, dk and dv
written once, 8 x S^2 x D FLOPs a head (dV, dP, dQ, dK). S is the true
token count: padding is the program's choice, not work.
"""
from __future__ import annotations

from typing import List, NamedTuple

from .device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

BYTES = {"bfloat16": 2, "float32": 4}


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


def prefix_flops(config: dict) -> float:
    """Every view through the layers below the LoRA window."""
    return config["ttl"]["views"] * config["ttl"]["lora_layers"][0] \
        * layer_flops(config)


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


class AttentionCall(NamedTuple):
    batch: int      # sequences (images x views)
    tokens: int
    heads: int
    head_dim: int

    def forward_bound_s(self, dtype_bytes: int) -> float:
        elems = self.batch * self.tokens * self.heads * self.head_dim
        flops = 4 * self.batch * self.heads * self.tokens ** 2 \
            * self.head_dim
        return max(4 * elems * dtype_bytes / PEAK_HBM_BYTES_PER_S,
                   flops / PEAK_BF16_FLOPS)

    def backward_bound_s(self, dtype_bytes: int) -> float:
        elems = self.batch * self.tokens * self.heads * self.head_dim
        flops = 8 * self.batch * self.heads * self.tokens ** 2 \
            * self.head_dim
        return max(7 * elems * dtype_bytes / PEAK_HBM_BYTES_PER_S,
                   flops / PEAK_BF16_FLOPS)


def attention_calls(config: dict, images: int
                    ) -> tuple[List[AttentionCall], List[AttentionCall]]:
    """(forward calls, backward calls) of one adapted step over `images`
    images: every view through every layer, the window's backward, and the
    clean view through the window twice (adapted, zero-shot)."""
    v, s = _vision(config)
    heads = v["num_attention_heads"]
    hd = v["hidden_size"] // heads
    layers = v["num_hidden_layers"]
    views = config["ttl"]["views"]
    window = layers - config["ttl"]["lora_layers"][0]
    fwd = [AttentionCall(images * views, s, heads, hd)] * layers \
        + [AttentionCall(images, s, heads, hd)] * (2 * window)
    bwd = [AttentionCall(images * views, s, heads, hd)] * window
    return fwd, bwd
