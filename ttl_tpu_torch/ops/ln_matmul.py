"""Layernorm folded into the linear that follows it (forward only).

Counterpart of `ttl_tpu/ops/ln_matmul.py`: out = layer_norm(x; scale, bias,
eps) @ w + b for x [..., K] and w [K, N], with f32 row statistics (the
centered variance), the affine in f32, the normalised row rounded once to
x's dtype and the product accumulated in f32. The caller names the
epilogue:

- "f32" (the JAX `ln_matmul`'s): the bias, in f32, added to the f32
  accumulator before the single cast back to x's dtype. That is one
  rounding fewer than `models.clip.layer_norm` followed by
  `models.clip.linear`: at bf16 the two differ by up to one bf16 step of
  the output, at f32 by summation order.
- "linear": the product rounded to x's dtype, then the bias, in x's dtype,
  added and rounded again, as `models.clip.linear` computes; with
  `quick_gelu=True` then `models.clip.quick_gelu` at the points where its
  ops round. This is the function of `layer_norm` -> `linear` (->
  `quick_gelu`); only the order of the product's sums differs on the card.

`stats="rms"` takes the RMS statistics of an RMSNorm in place of the
layernorm (AIMv2's, `models/aimv2.py`): h = (x * rsqrt(mean(x^2) + eps)) *
scale, rounded once, the function of `ops.layer_norm`'s "rms" code; there
is no layernorm bias (`ln_bias` None), and it comes with the "linear"
epilogue alone. A linear without a bias (`b` None) is run as one with a
zero bias: T(T(acc) + 0) is T(acc).

`ln_matmul` dispatches on the device of x. A CPU tensor takes
`ln_matmul_plain`. A CUDA tensor launches K6, the hand-written kernel in
`csrc/ln_matmul.cu`, which keeps the normalised x in shared memory; anything
the kernel does not take raises. `ln_matmul.launches` grows by one at each
kernel launch, `ln_matmul.linear_launches` at each launch with the "linear"
epilogue, `ln_matmul.rms_launches` at each launch with the RMS statistics.
There is no backward: its callers are the frozen vision tower of the CoCoOp
step (`models.clip.encode_image(fold="f32")`, "f32") and the
frozen prefix wherever no gradient reaches it
(`models.clip.vision_prefix`, "linear"); `models.clip.encoder_layer`'s
`fold` names the epilogue.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C interface's epilogue codes, by (epilogue, quick_gelu)
_EPILOGUES = {("f32", False): 0, ("linear", False): 1, ("linear", True): 2}
_STATS_CODES = {"centered": 0, "rms": 1}


def _epilogue_code(epilogue: str, quick_gelu: bool,
                   stats: str = "centered") -> int:
    code = _EPILOGUES.get((epilogue, bool(quick_gelu)))
    if code is None:
        raise ValueError(f"K6 epilogue: 'f32' or 'linear' (quick_gelu only "
                         f"with 'linear'), got {epilogue!r}, quick_gelu="
                         f"{quick_gelu}")
    if stats not in _STATS_CODES:
        raise ValueError(f"K6 stats: one of {tuple(_STATS_CODES)}, got "
                         f"{stats!r}")
    if stats == "rms" and code != 1:
        raise ValueError("K6's RMS statistics come with the 'linear' "
                         "epilogue alone, without quick_gelu")
    return code


def ln_matmul_plain(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias,
                    w: torch.Tensor, b, eps: float = 1e-5,
                    epilogue: str = "f32", quick_gelu: bool = False,
                    stats: str = "centered") -> torch.Tensor:
    """Plain PyTorch version of K6, step by step as the kernel (and the
    Pallas kernel it replaces) computes: products of values in x's dtype are
    exact in f32, so the f32 matmul of the upcast operands is the f32
    accumulation. The "linear" epilogue is written as `models.clip.linear`
    and `quick_gelu` compute it, so that a CPU tensor gets their bits; so is
    the RMS statistics' prologue as `ops.layer_norm.layer_norm_plain`'s, and
    a `b` of None adds nothing, as `linear` without a bias."""
    _epilogue_code(epilogue, quick_gelu, stats)
    x32 = x.float()
    if stats == "rms":
        rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
        h = ((x32 * rstd) * ln_scale.float()).to(x.dtype)
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        h = ((x32 - mu) * torch.rsqrt(var + eps) * ln_scale.float()
             + ln_bias.float()).to(x.dtype)
    if epilogue == "f32":
        acc = torch.matmul(h.float(), w.to(x.dtype).float())
        return (acc + b.float()).to(x.dtype)
    y = torch.matmul(h, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y * torch.sigmoid(1.702 * y) if quick_gelu else y


def ln_matmul_cuda(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias,
                   w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5,
                   epilogue: str = "f32", quick_gelu: bool = False,
                   stats: str = "centered") -> torch.Tensor:
    """Launch K6 on the current stream: x [M, K] and w [K, N] bf16 or f32
    (one dtype), ln_scale and ln_bias [K] f32 (ln_bias not read, and may be
    None, under stats="rms"), b [N] f32 under the "f32" epilogue and in x's
    dtype under "linear" -> [M, N] in x's dtype. K and N are multiples of
    16."""
    code = _epilogue_code(epilogue, quick_gelu, stats)
    if ln_bias is None:
        ln_bias = ln_scale          # not read under the RMS statistics
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
                           ("b", b, torch.float32 if code == 0
                            else x.dtype)):
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
        b.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], code,
        _STATS_CODES[stats], m, k, n, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"ln_matmul at M={m}, K={k}, N={n}, {x.dtype}, "
                     f"epilogue {epilogue}{' + quick_gelu' * quick_gelu}, "
                     f"{stats}")
    ln_matmul.launches += 1
    ln_matmul.linear_launches += code != 0
    ln_matmul.rms_launches += stats == "rms"
    return out


def ln_matmul(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias,
              w: torch.Tensor, b, eps: float = 1e-5, epilogue: str = "f32",
              quick_gelu: bool = False,
              stats: str = "centered") -> torch.Tensor:
    """out = layer_norm(x) @ w + b for x [..., K], with the epilogue the
    caller names (see the module): the plain version for a CPU tensor, K6
    for a CUDA tensor. w is taken in x's dtype and row-major, the
    layernorm's vectors in f32 and b in the epilogue's dtype, converted here
    when the parameters are stored otherwise (a checkpoint's transposed
    weights are copied each call). stats="rms": the RMSNorm's statistics,
    `ln_bias` None; `b` None: no bias."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, ln_scale, ln_bias, w, b, eps, epilogue,
                               quick_gelu, stats)
    if x.device.type != "cuda":
        raise ValueError(f"no fused layernorm + linear for device {x.device}")
    dtype = torch.float32 if epilogue == "f32" else x.dtype
    b = (torch.zeros(w.shape[-1], dtype=dtype, device=x.device) if b is None
         else b.to(dtype))
    out = ln_matmul_cuda(x.reshape(-1, x.shape[-1]), ln_scale.float(),
                         None if ln_bias is None else ln_bias.float(),
                         w.to(x.dtype).contiguous(), b, eps, epilogue,
                         quick_gelu, stats)
    return out.reshape(*x.shape[:-1], out.shape[-1])


ln_matmul.launches = 0
ln_matmul.linear_launches = 0
ln_matmul.rms_launches = 0
