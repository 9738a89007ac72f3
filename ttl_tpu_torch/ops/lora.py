"""LoRA adapters: the episodic reset state of the q/v window.

Counterpart of `ttl_tpu/ops/lora.py`: A is [L, d_model, rank], drawn per
`init_method`; B is [L, rank, d_model] and zero, so a fresh adapter set adds
exactly nothing.
"""
from __future__ import annotations

import math

import torch


def lora_scale(rank: int, alpha: int = 32) -> float:
    """PEFT scaling alpha/r."""
    return alpha / rank


def _draw_A(gen: torch.Generator, shape, init_method) -> torch.Tensor:
    d_model, rank = shape[1], shape[2]
    if init_method in ("xavier", None):
        return torch.randn(shape, generator=gen) * math.sqrt(
            2.0 / (d_model + rank))
    if init_method == "gaussian":
        return torch.randn(shape, generator=gen)
    if init_method == "kaiming":
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / d_model)
    if init_method == "pretrained":
        bound = 1.0 / math.sqrt(d_model)
        return torch.rand(shape, generator=gen) * (2 * bound) - bound
    raise ValueError(f"Unsupported init_method: {init_method}")


def init_adapters(gen: torch.Generator, n_layers: int, d_model: int,
                  rank: int, init_method: str | None = "xavier", *,
                  device) -> dict:
    """Fresh adapters for an n_layers window, drawn on the host from `gen`
    (q's A first, then v's) and placed on `device` in float32."""
    shape = (n_layers, d_model, rank)
    a_q = _draw_A(gen, shape, init_method)
    a_v = _draw_A(gen, shape, init_method)
    zeros = torch.zeros(n_layers, rank, d_model)
    return {"q": {"A": a_q.to(device), "B": zeros.to(device)},
            "v": {"A": a_v.to(device), "B": zeros.clone().to(device)}}


def adapter_param_count(adapters: dict) -> int:
    return sum(t.numel() for ad in adapters.values() for t in ad.values())
