"""Layout-native ("bshd") attention for the vision towers.

Counterpart of the bshd route of `ttl_tpu/ops/attention.py`: q/k/v come in
the towers' own [B, S, H*D] layout and the output goes back in it. S may be
the tower's padded token count, with `seq_len` the true one: keys at
positions >= seq_len are masked, query rows there come out as values no
caller reads.

`attention_bshd` dispatches on the device of its inputs. A CPU tensor goes
through `attention_bshd_plain`, differentiated by autograd. A CUDA tensor
goes through `AttentionBSHD`, whose forward and backward are the hand-written
Hopper kernels in `csrc/attention_bshd.cu`; anything the kernels do not take
raises. The launch counts `attention_bshd.fwd_launches` and
`attention_bshd.bwd_launches` grow by one at each kernel launch.

Causal (text) towers do not come here: like the JAX package they stay on
`causal_attention_plain`, the einsum numerics with input-dtype scores.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

MASK_VALUE = -1e9
KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def attention_bshd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int,
                         seq_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel pair, with its numerics: f32
    scores, key mask at seq_len, f32 softmax, P cast to v's dtype, P.V
    accumulated in f32, output in v's dtype."""
    s = q.shape[1]
    d = q.shape[-1] // heads
    seq_len = s if seq_len is None else seq_len
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d))
    if seq_len < s:
        keep = torch.arange(s, device=q.device) < seq_len
        scores = torch.where(keep, scores, torch.full_like(scores, MASK_VALUE))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), vh.float()).to(v.dtype)
    return _merge_heads(out)


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """Causal attention for the text tower, in the numerics of the JAX
    einsum route (`reference_attention`): for low-precision inputs q is
    pre-scaled and the scores are stored in the input dtype; f32 inputs get
    f32 scores divided after. Softmax in f32, P.V accumulated in f32."""
    d = q.shape[-1] // heads
    s = q.shape[1]
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    if q.dtype != torch.float32:
        qh = (qh.float() * (1.0 / math.sqrt(d))).to(q.dtype)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)).to(
            q.dtype)
    else:
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores,
                         torch.full_like(scores, MASK_VALUE))
    w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), vh.float()).to(v.dtype)
    return _merge_heads(out)


def _check_kernel_args(tensors, heads: int, seq_len: int) -> int:
    """Validate the kernels' inputs; return the head dim."""
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"expected [B, S, H*D] tensors, got {tuple(q.shape)}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("the bshd attention kernels take CUDA tensors on "
                             f"one device, got {t.device} and {q.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError("the bshd attention kernels take float32 or "
                             f"bfloat16 tensors of one dtype, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs "
                             f"{tuple(q.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the bshd attention kernels take contiguous "
                             "tensors starting at 16-byte boundaries")
    b, s, hd = q.shape
    if heads <= 0 or hd % heads:
        raise ValueError(f"H*D={hd} is not divisible by heads={heads}")
    d = hd // heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if not 0 < seq_len <= s:
        raise ValueError(f"seq_len={seq_len} outside (0, {s}]")
    return d


def bshd_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, seq_len: int) -> torch.Tensor:
    """Launch the forward kernel (K1) on the current stream."""
    d = _check_kernel_args((q, k, v), heads, seq_len)
    b, s, _ = q.shape
    o = torch.empty_like(q)
    lib = _build.library()
    rc = lib.ttl_bshd_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, heads, d, seq_len, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f"bshd attention forward at S={s}, head dim {d}, "
                     f"{q.dtype}")
    attention_bshd.fwd_launches += 1
    return o


def bshd_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, heads: int, seq_len: int):
    """Launch the backward kernel (K2) on the current stream; returns
    (dq, dk, dv)."""
    d = _check_kernel_args((q, k, v, do), heads, seq_len)
    b, s, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # softmax statistics (m, l, rowsum(dP*P)), read and written only by the
    # key-tiled route
    stats = None
    if kernel_route(True, q.dtype, s, d) == "key-tiled FMA":
        stats = torch.empty(3, b * heads * s, dtype=torch.float32,
                            device=q.device)
    lib = _build.library()
    rc = lib.ttl_bshd_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if stats is None else stats.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, heads, d, seq_len, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f"bshd attention backward at S={s}, head dim {d}, "
                     f"{q.dtype}")
    attention_bshd.bwd_launches += 1
    return dq, dk, dv


ROUTES = ("tensor cores", "whole-head FMA", "key-tiled FMA")


def kernel_route(backward: bool, dtype: torch.dtype, s: int, d: int) -> str:
    """The kernel route a geometry takes on the card (builds the library)."""
    code = _build.library().ttl_bshd_attention_route(
        int(backward), _DTYPE_CODES[dtype], s, d)
    if code < 0:
        raise ValueError(f"no bshd attention kernel for {dtype}, head dim {d}")
    return ROUTES[code]


class AttentionBSHD(torch.autograd.Function):
    """K1 forward, K2 backward (recomputes the softmax from q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, seq_len: int):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.seq_len = heads, seq_len
        return bshd_forward_cuda(q, k, v, heads, seq_len)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = bshd_backward_cuda(q, k, v, do.contiguous(), ctx.heads,
                                        ctx.seq_len)
        return dq, dk, dv, None, None


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, seq_len: Optional[int] = None) -> torch.Tensor:
    """[B, S, H*D] -> [B, S, H*D] attention; keys >= seq_len are masked
    (seq_len None: all S are real). CPU tensors take the plain version,
    CUDA tensors the kernels."""
    seq_len = q.shape[1] if seq_len is None else seq_len
    if q.device.type == "cpu":
        return attention_bshd_plain(q, k, v, heads, seq_len)
    if q.device.type != "cuda":
        raise ValueError(f"no bshd attention for device {q.device}")
    return AttentionBSHD.apply(q, k, v, heads, seq_len)


attention_bshd.fwd_launches = 0
attention_bshd.bwd_launches = 0


def reset_launch_counts() -> None:
    attention_bshd.fwd_launches = 0
    attention_bshd.bwd_launches = 0
