"""The 2-D rotary position embedding of EVA02's vision tower, in plain
PyTorch.

EVA-CLIP's `VisionRotaryEmbeddingFast` (`eva_vit_model.py`, `rope.py`):
the patch at row r and column c of a g x g grid turns each interleaved pair
(t[2i], t[2i+1]) of a head's q and k,

    t <- t cos + rot(t) sin,    rot(t)[2i] = -t[2i+1], rot(t)[2i+1] = t[2i],

by an angle that both elements of the pair share. The first half of the
head's dims carries the row, the second half the column: pair j of a half
(j = 0 .. D/4 - 1) at position p has angle p * (g0 / g) * theta^(-2j / (D/2)),
g0 the grid the model was trained on (`pt_hw_seq_len`; the positions are
interpolated to the served grid, `intp_freq`). The class token is not
turned.

`rope_tables` gives the class token, and every pad row past the grid, cos 1
and sin 0, so that one elementwise pass covers the padded sequence and gives
those rows back unchanged; its sin carries rot's sign (-sin at even dims,
+sin at odd), so that the pass is t cos + swap(t) sin with swap exchanging
the two elements of each pair. The tables are computed once per geometry and
device, on the device, in float64, and kept in float32. The pass computes
in f32 (EVA's f32 tables promote the activations) and rounds once to t's
dtype. `rope.launches` grows by one at each application (a q or a k).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=16)
def rope_tables(grid: int, pretrain_grid: int, head_dim: int, theta: float,
                seq: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, signed sin), each [seq, 1, head_dim] f32 on `device`, for a
    sequence of the class token, the grid's patches in row-major order and
    pad rows up to `seq`."""
    if head_dim % 4:
        raise ValueError(f"2-D RoPE splits a head into two halves of pairs: "
                         f"head_dim must be a multiple of 4, got {head_dim}")
    if seq < grid * grid + 1:
        raise ValueError(f"a sequence of {seq} tokens holds no class token "
                         f"and {grid}x{grid} patches")
    f64 = dict(dtype=torch.float64, device=device)
    half = head_dim // 2
    inv_freq = theta ** (-2.0 * torch.arange(half // 2, **f64) / half)
    pos = torch.arange(grid, **f64) * (pretrain_grid / grid)
    angle = (pos[:, None] * inv_freq).repeat_interleave(2, dim=-1)  # [g, D/2]
    angle = torch.cat([angle[:, None].expand(grid, grid, half),
                       angle[None, :].expand(grid, grid, half)], dim=-1)
    angle = angle.reshape(grid * grid, head_dim)
    cos = torch.ones(seq, head_dim, **f64)
    sin = torch.zeros(seq, head_dim, **f64)
    cos[1:grid * grid + 1] = angle.cos()
    sin[1:grid * grid + 1] = angle.sin()
    sign = torch.tensor([-1.0, 1.0], **f64).repeat(half)
    return (cos.float()[:, None], (sin * sign).float()[:, None])


def rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
         heads: int) -> torch.Tensor:
    """t [B, S, H*D] (q or k, heads merged) turned by the tables of
    `rope_tables` for S tokens, in f32, rounded once to t's dtype. t may be
    a column slice of a wider tensor; the result is contiguous."""
    x = t.unflatten(-1, (heads, -1))
    swapped = x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    out = (x * cos + swapped * sin).to(t.dtype)
    rope.launches += 1
    return out.flatten(-2)


rope.launches = 0
