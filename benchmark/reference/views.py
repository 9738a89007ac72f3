"""The 64 views of a test image, in float32: a frozen copy of the program's
view recipe.

View 0 is the center view (the centered short-side square); views 1.. are
torchvision-style random resized crops (scale 0.08-1, aspect 3/4-4/3, ten
attempts, then the clamped center crop) with random horizontal flips. Each
crop is resized to the model's input size with the Keys cubic kernel
(a = -0.5), antialiased, one weight matrix per axis applied to the image's
square zero-padded canvas, then clamped to [0, 1] and normalized by the
architecture's mean and standard deviation.

The draws of dataset index `idx` under `seed` come from one host
`torch.Generator` seeded from numpy's SeedSequence([seed, idx]), in the
order area [n-1, 10], log ratio [n-1, 10], position [n-1, 2], flip [n-1].
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

SCALE = (0.08, 1.0)
RATIO = (3.0 / 4.0, 4.0 / 3.0)
ATTEMPTS = 10


def generator(seed: int, idx: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, idx]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(state[0]) << 31)
                                         ^ int(state[1]))


def draw(seed: int, idx: int, n_views: int) -> Dict[str, torch.Tensor]:
    g = generator(seed, idx)
    n = n_views - 1
    lo_r, hi_r = (float(np.log(np.float32(r))) for r in RATIO)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    return {"area": uniform((n, ATTEMPTS), *SCALE),
            "log_ratio": uniform((n, ATTEMPTS), lo_r, hi_r),
            "pos": torch.rand((n, 2), generator=g),
            "flip": torch.rand((n,), generator=g) < 0.5}


def draw_many(seed: int, idxs: Sequence[int], n_views: int):
    per = [draw(seed, int(i), n_views) for i in idxs]
    return {k: torch.stack([d[k] for d in per]) for k in per[0]}


def _crop_boxes(d, h, w):
    """[..., 4] (top, left, height, width) of each random crop."""
    h, w = h[..., None], w[..., None]
    area = h * w * d["area"]
    r = torch.exp(d["log_ratio"])
    cw = torch.round(torch.sqrt(area * r))
    ch = torch.round(torch.sqrt(area / r))
    ok = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    first = ok.to(torch.int32).argmax(dim=-1, keepdim=True)
    cw1, ch1 = cw.gather(-1, first)[..., 0], ch.gather(-1, first)[..., 0]
    h, w = h[..., 0], w[..., 0]
    top = torch.floor(d["pos"][..., 0] * (h - ch1 + 1.0))
    left = torch.floor(d["pos"][..., 1] * (w - cw1 + 1.0))
    aspect = w / h
    fw = torch.where(aspect < RATIO[0], w,
                     torch.where(aspect > RATIO[1], torch.round(h * RATIO[1]),
                                 w))
    fh = torch.where(aspect < RATIO[0], torch.round(w / RATIO[0]), h)
    fallback = torch.stack([torch.round((h - fh) / 2.0),
                            torch.round((w - fw) / 2.0), fh, fw], dim=-1)
    box = torch.stack([top, left, ch1, cw1], dim=-1)
    return torch.where(ok.any(dim=-1)[..., None], box, fallback)


def _center_box(h, w):
    short = torch.minimum(h, w)
    return torch.stack([(h - short) / 2.0, (w - short) / 2.0, short, short],
                       dim=-1)


def _cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _weights(start, length, n_in, n_out):
    """[..., n_in, n_out] resampling weights of the crop [start, start +
    length) of an axis resized to n_out, antialiased."""
    dev = start.device
    scale = (n_out / length)[..., None]
    shift = (-start * n_out / length)[..., None]
    inv = 1.0 / scale
    widen = torch.clamp(inv, min=1.0)
    at = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * inv \
        - shift * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]
    wts = _cubic((at[..., None, :] - src).abs() / widen[..., None])
    total = wts.sum(dim=-2, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (at >= -0.5) & (at <= n_in - 0.5)
    return torch.where(inside[..., None, :], wts, torch.zeros_like(wts))


def _normalize(x, mean, std):
    mean = torch.tensor(mean, device=x.device)[:, None, None]
    std = torch.tensor(std, device=x.device)[:, None, None]
    return (x - mean) / std


def render(canvases: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
           draws, size: int, mean, std) -> torch.Tensor:
    """uint8 canvases [N, C, C, 3] holding images of hs x ws pixels at
    their top left, and their draws [N, n-1, ...] -> float32 views
    [N, n, 3, size, size], normalized by the per-channel `mean` and `std`;
    with draws None, the center view alone [N, 1, 3, size, size]."""
    n, c = canvases.shape[:2]
    h, w = hs.float(), ws.float()
    boxes = _center_box(h, w)[:, None]
    if draws is not None:
        boxes = torch.cat([boxes, _crop_boxes(draws, h[:, None], w[:, None])],
                          dim=1)
    v = boxes.shape[1]
    wy = _weights(boxes[..., 0], boxes[..., 2], c, size)
    wx = _weights(boxes[..., 1], boxes[..., 3], c, size)
    rows = torch.matmul(wy.transpose(-1, -2),
                        canvases.float().reshape(n, 1, c, c * 3))
    rows = rows.reshape(n, v, size, c, 3).permute(0, 1, 4, 2, 3)
    views = torch.matmul(rows, wx[:, :, None])
    if draws is not None:
        flip = torch.cat([torch.zeros_like(draws["flip"][:, :1]),
                          draws["flip"]], dim=1)
        views = torch.where(flip[:, :, None, None, None], views.flip(-1),
                            views)
    return _normalize(torch.clamp(views / 255.0, 0.0, 1.0), mean, std)
