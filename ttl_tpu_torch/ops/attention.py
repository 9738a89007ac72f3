"""Attention for the CLIP towers: the route switch and the kernel wrappers.

Counterpart of `ttl_tpu/ops/attention.py`. `TTL_FUSED_ATTENTION` chooses the
route, as in the JAX package (`fused_mode`):

  unset, `bshd`        the layout-native kernel pair K1/K2 for non-causal
                       (vision) towers; causal (text) towers take the einsum
                       numerics of `einsum_attention_plain`
  `per_head`, `1`, `true`, `True`
                       K3: one block per (batch, head) of [B, H, S, D]
                       tensors, causal or not, both towers
  `heads`              K4: one block per batch element that walks its heads
  `0`, `off`, `xla`, `einsum`
                       the einsum numerics everywhere
  anything else        ValueError

bshd: q/k/v come in the towers' own [B, S, H*D] layout and the output goes
back in it. S may be the tower's padded token count, with `seq_len` the true
one: keys at positions >= seq_len are masked, query rows there come out as
values no caller reads.

Every wrapper (`attention_bshd`, `attention_per_head`, `attention_heads`)
dispatches on the device of its inputs. A CPU tensor goes through the
kernel's plain PyTorch version (`attention_bshd_plain`,
`attention_bhsd_plain`), differentiated by autograd. A CUDA tensor goes
through a `torch.autograd.Function` whose forward and backward are the
hand-written Hopper kernels in `csrc/attention_bshd.cu` (K1/K2) and
`csrc/attention_bhsd.cu` (K3/K4); anything the kernels do not take raises.
Each wrapper's launch counts (`.fwd_launches`, `.bwd_launches`) grow by one
at each kernel launch.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from . import _build

MASK_VALUE = -1e9
KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------- route switch

_ENV = "TTL_FUSED_ATTENTION"
_MODE_OF = {"": "bshd", "auto": "bshd", "bshd": "bshd",
            "1": "per_head", "true": "per_head", "True": "per_head",
            "per_head": "per_head", "heads": "heads",
            "0": "", "off": "", "xla": "", "einsum": ""}
MODES = ("bshd", "per_head", "heads", "")
_forced: list = []
_env_mode: Optional[str] = None


def parse_mode(value: str) -> str:
    """The route a TTL_FUSED_ATTENTION value names: 'bshd', 'per_head',
    'heads' or '' (the einsum numerics). An unknown value raises."""
    if value not in _MODE_OF:
        raise ValueError(f"{_ENV}={value!r}: expected one of "
                         f"{sorted(k for k in _MODE_OF if k)} or unset")
    return _MODE_OF[value]


def fused_mode() -> str:
    """The attention route of this process: an active `force_mode` wins,
    else TTL_FUSED_ATTENTION, read once and cached (`reset_mode` forgets
    it)."""
    global _env_mode
    if _forced:
        return _forced[-1]
    if _env_mode is None:
        _env_mode = parse_mode(os.environ.get(_ENV, ""))
    return _env_mode


def reset_mode() -> None:
    """Forget the cached TTL_FUSED_ATTENTION decision."""
    global _env_mode
    _env_mode = None


class force_mode:
    """Context manager pinning `fused_mode()` to a route ('bshd',
    'per_head', 'heads' or '')."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"unknown attention route {mode!r}; expected "
                             f"one of {MODES}")
        self.mode = mode

    def __enter__(self):
        _forced.append(self.mode)
        return self

    def __exit__(self, *exc):
        _forced.pop()
        return False



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


def einsum_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, causal: bool) -> torch.Tensor:
    """[B, S, H*D] attention in the numerics of the JAX einsum route
    (`reference_attention`): for low-precision inputs q is pre-scaled and
    the scores are stored in the input dtype; f32 inputs get f32 scores
    divided after. Softmax in f32, P.V accumulated in f32."""
    d = q.shape[-1] // heads
    s = q.shape[1]
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    if q.dtype != torch.float32:
        qh = (qh.float() * (1.0 / math.sqrt(d))).to(q.dtype)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)).to(
            q.dtype)
    else:
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(keep, scores,
                             torch.full_like(scores, MASK_VALUE))
    w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), vh.float()).to(v.dtype)
    return _merge_heads(out)


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """The default route of the text tower: `einsum_attention_plain`,
    causal."""
    return einsum_attention_plain(q, k, v, heads, causal=True)


def attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3 and K4 over [B, H, S, D], with their
    numerics: f32 scores, keys masked past the query's position when causal
    (kpos <= qpos kept), masked scores -1e9, f32 softmax, P cast to v's
    dtype, P.V accumulated in f32, output in v's dtype."""
    s, d = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(keep, scores,
                             torch.full_like(scores, MASK_VALUE))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(v.dtype)


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


# ------------------------------------------- K3 (per_head) and K4 (heads)

def _check_bhsd_args(tensors) -> None:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, S, D] tensors, got "
                         f"{tuple(q.shape)}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("the bhsd attention kernels take CUDA tensors "
                             f"on one device, got {t.device} and {q.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError("the bhsd attention kernels take float32 or "
                             f"bfloat16 tensors of one dtype, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs "
                             f"{tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError("the bhsd attention kernels take contiguous "
                             "tensors")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {KERNEL_HEAD_DIMS}")
    if min(q.shape) < 1:
        raise ValueError(f"empty tensor {tuple(q.shape)}")


def _bhsd_forward_cuda(wrapper, entry: str, q, k, v, causal: bool):
    _check_bhsd_args((q, k, v))
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    rc = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, s, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f"{entry} at {tuple(q.shape)}, {q.dtype}, "
                     f"causal={causal}")
    wrapper.fwd_launches += 1
    return o


def _bhsd_backward_cuda(wrapper, entry: str, q, k, v, do, causal: bool):
    _check_bhsd_args((q, k, v, do))
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # softmax statistics (m, l, rowsum(dP*P)) between the two kernels
    stats = torch.empty(3, b * h * s, dtype=torch.float32, device=q.device)
    rc = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, s, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f"{entry} at {tuple(q.shape)}, {q.dtype}, "
                     f"causal={causal}")
    wrapper.bwd_launches += 1
    return dq, dk, dv


def per_head_forward_cuda(q, k, v, causal: bool = False) -> torch.Tensor:
    """Launch the per_head forward kernel (K3) on the current stream."""
    return _bhsd_forward_cuda(attention_per_head,
                              "ttl_per_head_attention_fwd", q, k, v, causal)


def per_head_backward_cuda(q, k, v, do, causal: bool = False):
    """Launch the per_head backward kernels (K3); returns (dq, dk, dv)."""
    return _bhsd_backward_cuda(attention_per_head,
                               "ttl_per_head_attention_bwd", q, k, v, do,
                               causal)


def heads_forward_cuda(q, k, v, causal: bool = False) -> torch.Tensor:
    """Launch the heads forward kernel (K4) on the current stream."""
    return _bhsd_forward_cuda(attention_heads, "ttl_heads_attention_fwd",
                              q, k, v, causal)


def heads_backward_cuda(q, k, v, do, causal: bool = False):
    """Launch the heads backward kernels (K4); returns (dq, dk, dv)."""
    return _bhsd_backward_cuda(attention_heads, "ttl_heads_attention_bwd",
                               q, k, v, do, causal)


class AttentionPerHead(torch.autograd.Function):
    """K3 forward and backward (recomputes the softmax from q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return per_head_forward_cuda(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*per_head_backward_cuda(q, k, v, do.contiguous(),
                                        ctx.causal), None)


class AttentionHeads(torch.autograd.Function):
    """K4 forward and backward (recomputes the softmax from q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return heads_forward_cuda(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*heads_backward_cuda(q, k, v, do.contiguous(), ctx.causal),
                None)


def _attention_bhsd(function, q, k, v, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_bhsd_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no bhsd attention for device {q.device}")
    return function.apply(q, k, v, causal)


def attention_per_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False) -> torch.Tensor:
    """[B, H, S, D] -> [B, H, S, D] attention on the per_head route. CPU
    tensors take the plain version, CUDA tensors K3."""
    return _attention_bhsd(AttentionPerHead, q, k, v, causal)


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """[B, H, S, D] -> [B, H, S, D] attention on the heads route. CPU
    tensors take the plain version, CUDA tensors K4."""
    return _attention_bhsd(AttentionHeads, q, k, v, causal)


KERNEL_WRAPPERS = (attention_bshd, attention_per_head, attention_heads)


def reset_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.fwd_launches = 0
        wrapper.bwd_launches = 0


reset_launch_counts()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              causal: bool, seq_len: Optional[int] = None) -> torch.Tensor:
    """[B, S, H*D] multi-head attention on the route `fused_mode()` names,
    as `ttl_tpu/models/clip.py::_attention` dispatches it. `seq_len` marks a
    tower padded for the bshd route; the other routes mask no keys and
    refuse it."""
    mode = fused_mode()
    if mode == "bshd" and causal:
        mode = ""   # text towers stay on the einsum numerics
    if mode == "bshd":
        return attention_bshd(q, k, v, heads, seq_len)
    if seq_len is not None:
        raise ValueError(
            "pre-padded activations (seq_len set) require the bshd route; "
            "the einsum, per_head and heads routes mask no keys")
    if mode == "":
        return einsum_attention_plain(q, k, v, heads, causal)
    fn = attention_per_head if mode == "per_head" else attention_heads
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    return _merge_heads(fn(qh, kh, vh, causal))
