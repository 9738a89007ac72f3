"""Layernorm folded into the linear that follows it (forward only).

Counterpart of `ttl_tpu/ops/ln_matmul.py`: out = layer_norm(x; scale, bias,
eps) @ w + b for x [..., K] and w [K, N], with f32 row statistics (the
centered variance), the affine in f32, the normalised row rounded once to
x's dtype, the product accumulated in f32 and the bias added in f32 before
the single cast back to x's dtype. That is one rounding fewer than
`models.clip.layer_norm` followed by `models.clip.linear`, which rounds the
product and then adds the bias in the activation dtype: at bf16 the two
differ by up to one bf16 step of the output, at f32 by summation order.

`ln_matmul` dispatches on the device of x. A CPU tensor takes
`ln_matmul_plain`. A CUDA tensor launches K6, the hand-written kernel in
`csrc/ln_matmul.cu`, which keeps the normalised x in shared memory; anything
the kernel does not take raises. `ln_matmul.launches` grows by one at each
kernel launch. There is no backward: the frozen vision tower of the CoCoOp
step is its caller (`models.clip.encoder_layer(fused_ln=True)`).
"""
from __future__ import annotations

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ln_matmul_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K6, step by step as the kernel (and the
    Pallas kernel it replaces) computes: products of values in x's dtype are
    exact in f32, so the f32 matmul of the upcast operands is the f32
    accumulation."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    h = ((x32 - mu) * torch.rsqrt(var + eps) * ln_scale.float()
         + ln_bias.float()).to(x.dtype)
    acc = torch.matmul(h.float(), w.to(x.dtype).float())
    return (acc + b.float()).to(x.dtype)


def ln_matmul_cuda(x: torch.Tensor, ln_scale: torch.Tensor,
                   ln_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Launch K6 on the current stream: x [M, K] and w [K, N] bf16 or f32
    (one dtype), ln_scale and ln_bias [K] and b [N] f32 -> [M, N] in x's
    dtype. K and N are multiples of 16."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"K6: expected x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"K6: x must be one of {tuple(_DTYPE_CODES)}, got "
                         f"{x.dtype}")
    m, k = x.shape
    n = w.shape[1]
    for name, a, dtype in (("x", x, x.dtype), ("w", w, x.dtype),
                           ("ln_scale", ln_scale, torch.float32),
                           ("ln_bias", ln_bias, torch.float32),
                           ("b", b, torch.float32)):
        if a.device.type != "cuda" or a.device != x.device:
            raise ValueError(f"K6 takes CUDA tensors on one device; {name} "
                             f"is on {a.device}")
        if a.dtype != dtype:
            raise ValueError(f"K6: {name} must be {dtype}, got {a.dtype}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K6: {name} must be contiguous and start at a "
                             "16-byte boundary")
    if w.shape[0] != k or ln_scale.shape != (k,) or ln_bias.shape != (k,) \
            or b.shape != (n,):
        raise ValueError(f"K6 shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, ln_scale "
                         f"{tuple(ln_scale.shape)}, ln_bias "
                         f"{tuple(ln_bias.shape)}, b {tuple(b.shape)}")
    if k % 16 or n % 16 or m == 0 or k == 0 or n == 0:
        raise ValueError(f"K6 takes K and N multiples of 16 and M > 0, got "
                         f"M={m}, K={k}, N={n}")
    lib = _build.library()
    max_k = lib.ttl_ln_matmul_max_k(_DTYPE_CODES[x.dtype])
    if k > max_k:
        raise ValueError(f"K6 holds a whole row tile in shared memory: K is "
                         f"at most {max_k} at {x.dtype}, got {k}")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    rc = lib.ttl_ln_matmul(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], m, k, n,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"ln_matmul at M={m}, K={k}, N={n}, {x.dtype}")
    ln_matmul.launches += 1
    return out


def ln_matmul(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """out = layer_norm(x) @ w + b for x [..., K]: the plain version for a
    CPU tensor, K6 for a CUDA tensor. w is taken in x's dtype and the three
    vectors in f32, converted here when the parameters are stored
    otherwise."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, ln_scale, ln_bias, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused layernorm + linear for device {x.device}")
    out = ln_matmul_cuda(x.reshape(-1, x.shape[-1]), ln_scale.float(),
                         ln_bias.float(), w.to(x.dtype), b.float(), eps)
    return out.reshape(*x.shape[:-1], out.shape[-1])


ln_matmul.launches = 0
