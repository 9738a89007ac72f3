"""Operation and byte counts of the work a step must do, from the shapes.

What depends on the architecture (the FLOPs of a layer and of an adapted
image; the attention calls of a step) is in
`work/<architecture>.py`, found by the configuration's `architecture` key
(`manifest.work_counts`); this module hands each call there and keeps what
is shared: the prefix's FLOPs, and each attention call's least time on the
card.

The attention calls' bytes and FLOPs, for the kernels' rooflines: forward,
q, k and v read once and o written once, 4 x S^2 x D FLOPs a head;
backward, q, k, v and dO read once and dq, dk and dv written once, 8 x S^2
x D FLOPs a head (dV, dP, dQ, dK). S is the true token count: padding is
the program's choice, not work.
"""
from __future__ import annotations

from typing import List, NamedTuple

from .device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from .manifest import work_counts

BYTES = {"bfloat16": 2, "float32": 4}


def layer_flops(config: dict) -> float:
    """One view through one vision layer."""
    return work_counts(config).layer_flops(config)


def prefix_flops(config: dict) -> float:
    """Every view through the layers below the LoRA window."""
    return config["ttl"]["views"] * config["ttl"]["lora_layers"][0] \
        * layer_flops(config)


def image_flops(config: dict) -> float:
    """Model FLOPs of one adapted image on the served path."""
    return work_counts(config).image_flops(config)


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
    images."""
    fwd, bwd = work_counts(config).attention_calls(config, images)
    return ([AttentionCall(*c) for c in fwd],
            [AttentionCall(*c) for c in bwd])
