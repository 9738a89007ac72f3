"""SwiGLU, the gated activation of EVA02's MLP, with its backward.

For gu = [u | g] [..., 2F], the product of the fused [W1 | W2] with its
bias: swiglu(gu) = SiLU(u) * g [..., F], computed in f32 and rounded once to
gu's dtype. Its gradient with respect to gu is [du | dg]:

    du = dy * g * sig(u) * (1 + u * (1 - sig(u))),    dg = dy * SiLU(u),

also in f32 and rounded once. F is the width of gu's halves as stored: the
true width on the CPU (2730 at EVA02-L/14), on the card the padded one
(2736), whose columns past the true width are zero in u and g and so give 0
forward and [0 | 0] backward (`models/eva02.py::card_layout` lays out
[W1 | 0 | W2 | 0] where the weights are placed on the card).

A CPU tensor takes the plain versions (`swiglu_plain`, `swiglu_grad_plain`);
a CUDA tensor the hand-written kernels of `csrc/swiglu.cu`; anything the
kernels do not take raises. `swiglu` is an autograd function wherever a
gradient can flow: it keeps gu for the backward, nothing else.
`swiglu.launches` grows by one at each forward and each backward, on any
device (on the card, one kernel launch each).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def swiglu_plain(gu: torch.Tensor) -> torch.Tensor:
    """SiLU(u) * g in f32, rounded once to gu's dtype."""
    u, g = gu.float().chunk(2, dim=-1)
    return (F.silu(u) * g).to(gu.dtype)


def swiglu_grad_plain(gu: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """[du | dg] in f32, rounded once to gu's dtype."""
    u, g = gu.float().chunk(2, dim=-1)
    d = dy.float()
    sig = torch.sigmoid(u)
    du = d * g * sig * (1 + u * (1 - sig))
    return torch.cat([du, d * (u * sig)], dim=-1).to(gu.dtype)


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"SwiGLU: {name} must be {like.dtype} on "
                         f"{like.device}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"SwiGLU: {name} must be contiguous")


def _rows(gu: torch.Tensor):
    """(gu as [M, 2F], F) for the kernels."""
    if gu.dtype not in _DTYPE_CODES:
        raise ValueError(f"SwiGLU kernels take {tuple(_DTYPE_CODES)}, got "
                         f"{gu.dtype}")
    if gu.shape[-1] % 2:
        raise ValueError(f"SwiGLU: the last axis holds u and g side by "
                         f"side, got width {gu.shape[-1]}")
    _check("gu", gu, gu)
    return gu.reshape(-1, gu.shape[-1]), gu.shape[-1] // 2


def swiglu_cuda(gu: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream: gu [..., 2F] ->
    [..., F]."""
    rows, f = _rows(gu)
    out = torch.empty(*gu.shape[:-1], f, dtype=gu.dtype, device=gu.device)
    rc = _build.library().ttl_swiglu_fwd(
        rows.data_ptr(), out.data_ptr(), _DTYPE_CODES[gu.dtype],
        rows.shape[0], f, torch.cuda.current_stream(gu.device).cuda_stream)
    _build.check(rc, f"swiglu forward at M={rows.shape[0]}, F={f}, "
                     f"{gu.dtype}")
    return out


def swiglu_grad_cuda(gu: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on the current stream: gu [..., 2F], dy
    [..., F] -> [du | dg] [..., 2F]."""
    rows, f = _rows(gu)
    _check("dy", dy, gu)
    if dy.shape != (*gu.shape[:-1], f):
        raise ValueError(f"SwiGLU: dy {tuple(dy.shape)} does not match gu "
                         f"{tuple(gu.shape)}")
    out = torch.empty_like(gu)
    rc = _build.library().ttl_swiglu_bwd(
        rows.data_ptr(), dy.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[gu.dtype], rows.shape[0], f,
        torch.cuda.current_stream(gu.device).cuda_stream)
    _build.check(rc, f"swiglu backward at M={rows.shape[0]}, F={f}, "
                     f"{gu.dtype}")
    return out


def _forward(gu: torch.Tensor) -> torch.Tensor:
    swiglu.launches += 1
    if gu.device.type == "cpu":
        return swiglu_plain(gu)
    if gu.device.type != "cuda":
        raise ValueError(f"no SwiGLU for device {gu.device}")
    return swiglu_cuda(gu)


def _backward(gu: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    swiglu.launches += 1
    if gu.device.type == "cpu":
        return swiglu_grad_plain(gu, dy)
    return swiglu_grad_cuda(gu, dy.contiguous())


class SwiGLU(torch.autograd.Function):
    """swiglu with the hand-written backward; saves gu alone."""

    @staticmethod
    def forward(ctx, gu):
        ctx.save_for_backward(gu)
        return _forward(gu)

    @staticmethod
    def backward(ctx, dy):
        (gu,) = ctx.saved_tensors
        return _backward(gu, dy)


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """SiLU(u) * g for gu = [u | g] [..., 2F] -> [..., F] (see the module):
    the autograd function where a gradient can flow, else the forward
    alone."""
    if torch.is_grad_enabled() and gu.requires_grad:
        return SwiGLU.apply(gu)
    return _forward(gu)


swiglu.launches = 0
