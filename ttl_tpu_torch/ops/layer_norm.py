"""Layernorm over the last axis with f32 statistics, and its gradient with
respect to x.

For x [..., K] and the layernorm's scale and bias [K]:

    mu = mean(x),   rstd = rsqrt(mean((x - mu)^2) + eps),
    y  = ((x - mu) * rstd) * scale + bias,

(with stats="ex2" the variance is E[x^2] - mu^2, floored at 0),

in f32 with each operation rounded on its own, as the chain of tensor
operations rounds it, then y rounded once to x's dtype. The gradient is
taken with respect to x alone: with g = dy * scale and xh = (x - mu) * rstd,

    dx = rstd * (g - mean(g) - xh * mean(g * xh)),

in f32 and rounded once. Scale and bias take no gradient on any path of the
package (TTL trains LoRA adapters, TPT and CoCoOp the prompt's context), so
none is computed.

stats="rms" is the RMS statistics of an RMSNorm (AIMv2's,
`models/aimv2.py`): mu is taken as 0 and there is no bias,

    rstd = rsqrt(mean(x^2) + eps),   y = (x * rstd) * scale,
    dx   = rstd * (g - xh * mean(g * xh)),   xh = x * rstd,

rounded as above; it takes the full width only, and `bias` is not read
(None will do).

`width`, a logical width n <= K where the row holds padding: every
statistic, mean and division above runs over x[..., :n] (scale and bias
[K], their first n read), and y and dx are 0 in the columns past n. EVA02's
LN_ffn on the card normalises 2730 columns of a 2736-wide row
(`models/eva02.py::card_layout`). n = K (or `width` None) takes the
full-width code: on the card the kernels' unmasked instances.

`layer_norm_plain` is the plain version, the body `models.clip.layer_norm`
has always run and still runs on the CPU; `layer_norm_grad_plain` is the
gradient's. `layer_norm` runs them on a CPU tensor, and on a CUDA tensor
the hand-written kernels of `csrc/layer_norm.cu` (bf16 or f32, an even K up
to 4096, one pass each way); anything the kernels do not take raises. It
is an autograd function wherever a gradient can flow: it keeps x (in its
own dtype), mu and rstd ([M] f32 each) for the backward, and the scale it
was given. `layer_norm.launches` grows by one at each forward and each
backward, on any device (on the card, one kernel launch each),
`layer_norm.strided_launches` by one at each of those whose logical width
is below its row length, and `layer_norm.rms_launches` at each of those
with RMS statistics (on the card the kernels `rms_norm_fwd_kernel` and
`rms_norm_bwd_kernel`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STATS_CODES = {"centered": 0, "ex2": 1, "rms": 2}
MAX_K = 4096  # csrc/layer_norm.cu's kMaxK


def _logical(x: torch.Tensor, width) -> int:
    """The logical width of x's rows: `width`, or the row length where it
    is None."""
    k = x.shape[-1]
    if width is None:
        return k
    if not 1 <= width <= k:
        raise ValueError(f"layer_norm: the logical width must lie in "
                         f"[1, {k}], got {width}")
    return int(width)


def _check_stats(stats: str, x: torch.Tensor, width) -> None:
    if stats not in _STATS_CODES:
        raise ValueError(f"layer_norm: stats must be one of "
                         f"{tuple(_STATS_CODES)}, got {stats!r}")
    if stats == "rms" and _logical(x, width) < x.shape[-1]:
        raise ValueError("layer_norm: RMS statistics take the full width")


def _plain(x: torch.Tensor, scale: torch.Tensor, bias, eps: float,
           stats: str = "centered", width=None):
    """(y, mu, rstd), mu and rstd [..., 1] f32."""
    _check_stats(stats, x, width)
    if stats == "rms":
        x32 = x.float()
        rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
        y = ((x32 * rstd) * scale.float()).to(x.dtype)
        return y, torch.zeros_like(rstd), rstd
    n = _logical(x, width)
    if n < x.shape[-1]:
        y, mu, rstd = _plain(x[..., :n], scale[:n], bias[:n], eps, stats)
        return F.pad(y, (0, x.shape[-1] - n)), mu, rstd
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    if stats == "ex2":
        var = (x32.square().mean(dim=-1, keepdim=True)
               - mu.square()).clamp(min=0.0)
    else:
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mu) * rstd
    return (y * scale + bias).to(x.dtype), mu, rstd


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias, eps: float,
                     stats: str = "centered", width=None) -> torch.Tensor:
    """Layernorm with f32 statistics, output in x's dtype; the variance is
    the centered mean((x - mu)^2), or with stats="ex2" E[x^2] - mu^2
    floored at 0; over the first `width` columns, 0 past them. stats="rms":
    the RMSNorm (x * rsqrt(mean(x^2) + eps)) * scale, no bias."""
    return _plain(x, scale, bias, eps, stats, width)[0]


def layer_norm_grad_plain(x: torch.Tensor, dy: torch.Tensor,
                          scale: torch.Tensor, mu: torch.Tensor,
                          rstd: torch.Tensor, width=None,
                          stats: str = "centered") -> torch.Tensor:
    """dx in f32, rounded once to x's dtype; mu and rstd as the forward's
    (any shape that broadcasts over x's rows); over the first `width`
    columns, 0 past them. stats="rms": the RMSNorm's, without the mean's
    term (mu is not read)."""
    _check_stats(stats, x, width)
    if stats == "rms":
        x32 = x.float()
        rstd = rstd.reshape(*x.shape[:-1], 1)
        xh = x32 * rstd
        g = dy.float() * scale.float()
        mgx = (g * xh).sum(dim=-1, keepdim=True) / x.shape[-1]
        return (rstd * (g - xh * mgx)).to(x.dtype)
    n = _logical(x, width)
    if n < x.shape[-1]:
        dx = layer_norm_grad_plain(x[..., :n], dy[..., :n], scale[:n], mu,
                                   rstd)
        return F.pad(dx, (0, x.shape[-1] - n))
    x32 = x.float()
    k = x.shape[-1]
    mu = mu.reshape(*x.shape[:-1], 1)
    rstd = rstd.reshape(*x.shape[:-1], 1)
    xh = (x32 - mu) * rstd
    g = dy.float() * scale.float()
    mg = g.sum(dim=-1, keepdim=True) / k
    mgx = (g * xh).sum(dim=-1, keepdim=True) / k
    return (rstd * (g - mg - xh * mgx)).to(x.dtype)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous [M, K] rows on a boundary of a column pair (a copy
    only where t is strided or starts off one)."""
    t = t.contiguous()
    if t.data_ptr() % (2 * t.element_size()):
        t = t.clone()
    return t.reshape(-1, t.shape[-1])


def _param(t: torch.Tensor, k: int) -> torch.Tensor:
    if t.shape != (k,):
        raise ValueError(f"layer_norm: scale and bias must be [{k}], got "
                         f"{tuple(t.shape)}")
    return t.float().contiguous()


def _check(x: torch.Tensor) -> None:
    k = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPE_CODES or k % 2 or not 2 <= k <= MAX_K:
        raise ValueError(f"layer_norm kernels take {tuple(_DTYPE_CODES)} at "
                         f"an even width up to {MAX_K}, got {x.dtype} at "
                         f"{tuple(x.shape)}")


def layer_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float, with_stats: bool = False,
                    stats: str = "centered", width=None):
    """Launch the forward kernel on the current stream: (y like x, and mu,
    rstd [M] f32 where `with_stats`, else None, None)."""
    _check(x)
    n = _logical(x, width)
    _check_stats(stats, x, width)
    rows = _rows(x)
    m, k = rows.shape
    sc = _param(scale, k)
    bi = sc if stats == "rms" else _param(bias, k)    # not read under rms
    y = torch.empty_like(rows)
    mu = rstd = None
    if with_stats:
        mu = torch.empty(m, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    rc = _build.library().ttl_layer_norm_fwd(
        rows.data_ptr(), sc.data_ptr(), bi.data_ptr(), y.data_ptr(),
        None if mu is None else mu.data_ptr(),
        None if rstd is None else rstd.data_ptr(), _DTYPE_CODES[x.dtype],
        m, k, n, float(eps), _STATS_CODES[stats],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"layer_norm forward at M={m}, K={k}, n={n}, "
                     f"{x.dtype}, {stats}")
    return y.view(x.shape), mu, rstd


def layer_norm_grad_cuda(x: torch.Tensor, dy: torch.Tensor,
                         scale: torch.Tensor, mu: torch.Tensor,
                         rstd: torch.Tensor, width=None,
                         stats: str = "centered") -> torch.Tensor:
    """Launch the backward kernel on the current stream: dx like x."""
    _check(x)
    n = _logical(x, width)
    _check_stats(stats, x, width)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"layer_norm: dy {dy.dtype} {tuple(dy.shape)} does "
                         f"not match x {x.dtype} {tuple(x.shape)}")
    rows, d = _rows(x), _rows(dy)
    m, k = rows.shape
    sc = _param(scale, k)
    mu, rstd = mu.float().contiguous(), rstd.float().contiguous()
    if mu.numel() != m or rstd.numel() != m:
        raise ValueError(f"layer_norm: mu and rstd must hold {m} rows")
    dx = torch.empty_like(rows)
    rc = _build.library().ttl_layer_norm_bwd(
        rows.data_ptr(), d.data_ptr(), sc.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), _DTYPE_CODES[x.dtype], m, k, n,
        _STATS_CODES[stats], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"layer_norm backward at M={m}, K={k}, n={n}, "
                     f"{x.dtype}, {stats}")
    return dx.view(x.shape)


def _count(x, width, stats: str) -> None:
    layer_norm.launches += 1
    if _logical(x, width) < x.shape[-1]:
        layer_norm.strided_launches += 1
    layer_norm.rms_launches += stats == "rms"


def _forward(x, scale, bias, eps, stats: str, width, with_stats: bool):
    if x.device.type == "cpu":
        y, mu, rstd = _plain(x, scale, bias, eps, stats, width)
        out = y, mu.flatten(), rstd.flatten()
    elif x.device.type == "cuda":
        out = layer_norm_cuda(x, scale, bias, eps, with_stats, stats, width)
    else:
        raise ValueError(f"no layer_norm for device {x.device}")
    _count(x, width, stats)
    return out


def _backward(x, dy, scale, mu, rstd, width, stats: str) -> torch.Tensor:
    if x.device.type == "cpu":
        dx = layer_norm_grad_plain(x, dy, scale, mu, rstd, width, stats)
    else:
        dx = layer_norm_grad_cuda(x, dy, scale, mu, rstd, width, stats)
    _count(x, width, stats)
    return dx


class LayerNorm(torch.autograd.Function):
    """layer_norm with the hand-written dx backward; saves x, mu, rstd and
    the scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, stats, width):
        y, mu, rstd = _forward(x, scale, bias, eps, stats, width,
                               with_stats=True)
        ctx.save_for_backward(x, scale, mu, rstd)
        ctx.width, ctx.stats = width, stats
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mu, rstd = ctx.saved_tensors
        dx = _backward(x, dy, scale, mu, rstd, ctx.width, ctx.stats)
        return dx, None, None, None, None, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias, eps: float,
               stats: str = "centered", width=None) -> torch.Tensor:
    """The layernorm of x [..., K] (see the module), over its first `width`
    columns where given: the autograd function where a gradient can flow
    to x, else the forward alone. Scale and bias take no gradient: one that
    needs one raises. Under stats="rms" `bias` is not read."""
    if scale.requires_grad or (bias is not None and bias.requires_grad):
        raise ValueError("layer_norm computes no gradient for its scale and "
                         "bias: run layer_norm_plain where they are trained")
    if torch.is_grad_enabled() and x.requires_grad:
        return LayerNorm.apply(x, scale, bias, eps, stats, width)
    return _forward(x, scale, bias, eps, stats, width, with_stats=False)[0]


layer_norm.launches = 0
layer_norm.strided_launches = 0
layer_norm.rms_launches = 0
