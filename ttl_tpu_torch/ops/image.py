"""View generation: 1 center view + (n-1) random-resized-crop/flip views,
optionally AugMix-mixed, and the single center view of zero-shot evaluation
(`preprocess_center`).

Counterpart of `ttl_tpu/ops/image.py`, split in two:

- `draw_view_params` makes a sample's random draws on the host from a
  `torch.Generator` seeded from (seed, dataset index), so a sample's views do
  not depend on the batch it lands in. With AugMix ops it goes on to draw
  each view's mix and its three chains from the same generator.
- `render_views` turns uint8 canvases and those draws into normalized views
  on the canvases' device.

Crop + resize is JAX's `scale_and_translate` with the Keys cubic kernel
(a = -0.5) and antialiasing, rebuilt as one weight matrix per axis and view
(JAX's `compute_weight_mat`) applied as two batched matmuls over the f32
canvas. The canvas is read as JAX reads it, zero padding included.
`resize_bilinear` is `jax.image.resize(method="bilinear")` built the same
way, with the triangle kernel, which antialiases when it shrinks.

AugMix (`aug_ops`): each random view v in [0, 1] becomes
m * v + (1 - m) * sum_i w_i * chain_i(v), w ~ Dirichlet(1, 1, 1) (three
-log(U) normalised), m ~ U(0, 1), each chain one to three ops of
`ops/augmix.py` drawn uniformly from `aug_ops`. The center view is not mixed.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .augmix import CHAIN_SLOTS, apply_chains

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

RRC_SCALE = (0.08, 1.0)
RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)
RRC_ATTEMPTS = 10
AUGMIX_CHAINS = 3

Draws = Dict[str, torch.Tensor]


def sample_generator(seed: int, idx: int, *stream: int) -> torch.Generator:
    """The host generator of dataset index `idx` under `seed`; `stream`
    names another independent stream of the same sample."""
    state = np.random.SeedSequence([seed, idx, *stream]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def draw_view_params(seed: int, idx: int, n_views: int, n_aug_ops: int = 0,
                     severity: float = 1) -> Draws:
    """The random draws of one sample's n_views - 1 random views:
    area [n-1, 10] in [0.08, 1), log_ratio [n-1, 10] in
    [log(3/4), log(4/3)), pos [n-1, 2] in [0, 1), flip [n-1] bool. With
    `n_aug_ops` AugMix ops, then from the same generator: mix_w [n-1, 3]
    ~ Dirichlet(1, 1, 1), mix_m [n-1] ~ U(0, 1), and for each view's three
    chains depth [n-1, 3] in {1, 2, 3}, op [n-1, 3, 3] in [0, n_aug_ops),
    level [n-1, 3, 3] in [0.1, severity) and sign [n-1, 3, 3] bool, one per
    chain and slot."""
    g = sample_generator(seed, idx)
    n = n_views - 1
    lo_r, hi_r = (float(np.log(np.float32(r))) for r in RRC_RATIO)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    draws = {
        "area": uniform((n, RRC_ATTEMPTS), *RRC_SCALE),
        "log_ratio": uniform((n, RRC_ATTEMPTS), lo_r, hi_r),
        "pos": torch.rand((n, 2), generator=g),
        "flip": torch.rand((n,), generator=g) < 0.5,
    }
    if n_aug_ops:
        slots = (n, AUGMIX_CHAINS, CHAIN_SLOTS)
        gamma = -torch.log1p(-torch.rand((n, AUGMIX_CHAINS), generator=g))
        draws.update(
            mix_w=gamma / gamma.sum(dim=-1, keepdim=True),
            mix_m=torch.rand((n,), generator=g),
            depth=torch.randint(1, CHAIN_SLOTS + 1, (n, AUGMIX_CHAINS),
                                generator=g),
            op=torch.randint(0, n_aug_ops, slots, generator=g),
            level=uniform(slots, 0.1, float(severity)),
            sign=torch.rand(slots, generator=g) < 0.5)
    return draws


def draw_batch(seed: int, idxs: Sequence[int], n_views: int,
               n_aug_ops: int = 0, severity: float = 1) -> Draws:
    """draw_view_params for each dataset index, stacked on a leading axis."""
    per = [draw_view_params(seed, int(i), n_views, n_aug_ops, severity)
           for i in idxs]
    return {k: torch.stack([d[k] for d in per]) for k in per[0]}


def sample_rrc_box(draws: Draws, h: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    """torchvision RandomResizedCrop.get_params over the attempts axis: the
    first valid attempt wins, else the aspect-clamped center crop.
    h, w: [...] f32; draws: [..., 10] -> boxes [..., 4] (top, left, ch, cw)."""
    h, w = h[..., None], w[..., None]
    target_area = (h * w) * draws["area"]
    r = torch.exp(draws["log_ratio"])
    cw = torch.round(torch.sqrt(target_area * r))
    ch = torch.round(torch.sqrt(target_area / r))
    valid = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    first = valid.to(torch.int32).argmax(dim=-1, keepdim=True)
    any_valid = valid.any(dim=-1)
    cw_v = cw.gather(-1, first)[..., 0]
    ch_v = ch.gather(-1, first)[..., 0]
    h, w = h[..., 0], w[..., 0]
    top_v = torch.floor(draws["pos"][..., 0] * (h - ch_v + 1.0))
    left_v = torch.floor(draws["pos"][..., 1] * (w - cw_v + 1.0))

    in_ratio = w / h
    lo, hi = RRC_RATIO
    cw_f = torch.where(in_ratio < lo, w,
                       torch.where(in_ratio > hi, torch.round(h * hi), w))
    ch_f = torch.where(in_ratio < lo, torch.round(w / lo), h)
    top_f = torch.round((h - ch_f) / 2.0)
    left_f = torch.round((w - cw_f) / 2.0)
    valid_box = torch.stack([top_v, left_v, ch_v, cw_v], dim=-1)
    fallback = torch.stack([top_f, left_f, ch_f, cw_f], dim=-1)
    return torch.where(any_valid[..., None], valid_box, fallback)


def center_box(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Resize(short side) + CenterCrop == the centered short-side square."""
    short = torch.minimum(h, w)
    return torch.stack([(h - short) / 2.0, (w - short) / 2.0, short, short],
                       dim=-1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def weight_mat(start: torch.Tensor, length: torch.Tensor, in_size: int,
               out_size: int, kernel=_keys_cubic) -> torch.Tensor:
    """JAX's compute_weight_mat for the crop [start, start + length) of an
    axis of in_size pixels resized to out_size, antialiased, with the Keys
    cubic kernel (or `kernel`). start, length: [...] f32 ->
    [..., in_size, out_size]."""
    dev = start.device
    scale = (out_size / length)[..., None]
    translation = (-start * out_size / length)[..., None]
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - translation * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
    x = (sample_f[..., None, :] - src).abs() / kernel_scale[..., None]
    weights = kernel(x)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights,
                       torch.zeros_like(weights))


def crop_resize(canvases: torch.Tensor, boxes: torch.Tensor,
                out_size: int) -> torch.Tensor:
    """canvases [S, C, C, 3] (f32, 0..255), boxes [S, V, 4] ->
    views [S, V, 3, out, out]."""
    s, c = canvases.shape[0], canvases.shape[1]
    v = boxes.shape[1]
    wy = weight_mat(boxes[..., 0], boxes[..., 2], c, out_size)  # [S,V,C,out]
    wx = weight_mat(boxes[..., 1], boxes[..., 3], c, out_size)
    rows = torch.matmul(wy.transpose(-1, -2),
                        canvases.reshape(s, 1, c, c * 3))   # [S,V,out,C*3]
    rows = rows.reshape(s, v, out_size, c, 3).permute(0, 1, 4, 2, 3)
    return torch.matmul(rows, wx[:, :, None])               # [S,V,3,out,out]


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """x [..., H, W] -> [..., size, size] (or [..., *size] for a pair), as
    `jax.image.resize(method="bilinear")`: the triangle kernel, widened to
    antialias where an axis shrinks, one weight matrix per axis in x's
    dtype, H contracted first and each product rounded to x's dtype; an
    axis already at its size is kept."""
    sizes = (size, size) if isinstance(size, int) else tuple(size)
    for dim, size in zip((-2, -1), sizes):
        n = x.shape[dim]
        if n == size:
            continue
        zero = torch.zeros((), device=x.device)
        w = weight_mat(zero, zero + n, n, size, _triangle).to(x.dtype)
        x = torch.matmul(x.transpose(dim, -1), w).transpose(dim, -1)
    return x


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] in [0, 1] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


def preprocess_center(canvases: torch.Tensor, hs: torch.Tensor,
                      ws: torch.Tensor, out_size: int = 224,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The deterministic eval view of each canvas: uint8 [S, C, C, 3] with
    true extents hs, ws [S] -> CLIP-normalized [S, 3, out, out]."""
    boxes = center_box(hs.float(), ws.float())[:, None]
    views = crop_resize(canvases.float(), boxes, out_size)[:, 0]
    return normalize(torch.clamp(views / 255.0, 0.0, 1.0)).to(out_dtype)


def augmix(v01: torch.Tensor, draws: Draws,
           aug_ops: Sequence[str]) -> torch.Tensor:
    """The AugMix mix of views v01 [S, n-1, 3, H, W] in [0, 1] with their
    stacked draws: three chains of each view, all views' chains run
    together (`ops/augmix.py::apply_chains`)."""
    s, n = v01.shape[:2]
    chains = apply_chains(
        v01.unsqueeze(2).expand(s, n, AUGMIX_CHAINS, *v01.shape[2:])
        .flatten(0, 2),
        draws["depth"].flatten(), draws["op"].flatten(0, 2),
        draws["level"].flatten(0, 2), draws["sign"].flatten(0, 2), aug_ops)
    chains = chains.unflatten(0, (s, n, AUGMIX_CHAINS))
    mixed = (draws["mix_w"][..., None, None, None] * chains).sum(dim=2)
    m = draws["mix_m"][..., None, None, None]
    return m * v01 + (1.0 - m) * mixed


def render_views(canvases: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                 draws: Draws, out_size: int = 224,
                 out_dtype=torch.bfloat16,
                 aug_ops: Sequence[str] = ()) -> torch.Tensor:
    """uint8 canvases [S, C, C, 3] with true extents hs, ws [S] and stacked
    draws [S, n-1, ...] -> views [S, n, 3, out, out] in out_dtype: view 0
    the center view, views 1.. the random crops, each flipped where its
    flip bit is set and, with `aug_ops`, AugMix-mixed (the draws then carry
    the mix's, `draw_batch(n_aug_ops=len(aug_ops))`)."""
    h, w = hs.float(), ws.float()
    boxes = torch.cat([center_box(h, w)[:, None],
                       sample_rrc_box(draws, h[:, None], w[:, None])], dim=1)
    views = crop_resize(canvases.float(), boxes, out_size)
    flip = torch.cat([torch.zeros_like(draws["flip"][:, :1]), draws["flip"]],
                     dim=1)
    views = torch.where(flip[:, :, None, None, None], views.flip(-1), views)
    views = torch.clamp(views / 255.0, 0.0, 1.0)
    if aug_ops:
        views = torch.cat([views[:, :1], augmix(views[:, 1:], draws,
                                                aug_ops)], dim=1)
    return normalize(views).to(out_dtype)

