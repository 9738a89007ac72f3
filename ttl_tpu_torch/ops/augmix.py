"""The AugMix operation set, batched over images on their device.

Counterpart of `ttl_tpu/ops/augmix.py`: the 13 ops (autocontrast, equalize,
posterize, rotate, solarize, shear_x/y, translate_x/y, color, contrast,
brightness, sharpness), their level rules and the chain of one to three ops
the view maker mixes. Every op takes images [N, 3, H, W] f32 in [0, 1] and
per-image draws: `level` [N] f32 in [0.1, severity) and `sign` [N] bool (a
sign flip, read by the geometric ops only). The JAX ops draw these inside
from a key; here they are drawn on the host (`ops/image.py`) and passed in.

The geometric ops resample as `jax.scipy.ndimage.map_coordinates(order=1,
cval=0)` does, written out: the four neighbours of each source coordinate,
each outside the image counting as zero, weighted and summed in JAX's order.
`equalize` builds its per-channel histograms with one `bincount`, exact.

`apply_chains` runs the chains of many images at once: for each of the three
slots and each op, over the images whose chain is that deep and picks that
op there, so the launches grow with ops x depth and not with images.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

IMAGE_SIZE = 224   # the translate ops' scale, whatever the view size

AUG_NAMES = ("autocontrast", "equalize", "posterize", "rotate", "solarize",
             "shear_x", "shear_y", "translate_x", "translate_y",
             "color", "contrast", "brightness", "sharpness")
DEFAULT_AUG_LIST = AUG_NAMES[:9]
CHAIN_SLOTS = 3


def _int_parameter(level: torch.Tensor, maxval: float) -> torch.Tensor:
    return torch.floor(level * maxval / 10.0)


def _float_parameter(level: torch.Tensor, maxval: float) -> torch.Tensor:
    return level * maxval / 10.0


def _signed(sign: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(sign, -x, x)


def _per_image(t: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 1, 1] for the coordinate grids."""
    return t.reshape(-1, 1, 1)


def _affine(img: torch.Tensor, a, b, c, d, e, f) -> torch.Tensor:
    """PIL's AFFINE transform: output(x, y) = input(a x + b y + c,
    d x + e y + f), bilinear, zero outside. Coefficients are [N] tensors."""
    n, ch, h, w = img.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    a, b, c, d, e, f = (_per_image(t) for t in (a, b, c, d, e, f))
    x_in = a * xs + b * ys + c
    y_in = d * xs + e * ys + f
    flat = img.reshape(n, ch, h * w)

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return [(index, 1 - upper_w), (index + 1, upper_w)]

    out = None
    for yi, wy in nodes(y_in):
        for xi, wx in nodes(x_in):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            pos = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(
                n, 1, h * w).expand(n, ch, h * w)
            value = torch.where(valid.reshape(n, 1, h * w),
                                torch.gather(flat, 2, pos),
                                torch.zeros((), dtype=img.dtype,
                                            device=img.device))
            term = (wy * wx).reshape(n, 1, h * w) * value
            out = term if out is None else out + term
    return out.reshape(n, ch, h, w)


def _rotate(img: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise rotation about the centre (PIL's rotate)."""
    h, w = img.shape[-2:]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    t = degrees * math.pi / 180.0
    ca, sa = torch.cos(t), torch.sin(t)
    a, b = ca, -sa
    d, e = sa, ca
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return _affine(img, a, b, c, d, e, f)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """PIL's 'L' weights: [N, 3, H, W] -> [N, 1, H, W]."""
    return (0.299 * img[:, 0] + 0.587 * img[:, 1]
            + 0.114 * img[:, 2]).unsqueeze(1)


def _blend(degenerate, img, factor):
    return torch.clamp(degenerate + factor * (img - degenerate), 0.0, 1.0)


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(img * 255.0), 0, 255)


# -------------------------------------------------------------------- the ops

def autocontrast(img, level, sign):
    lo = img.amin(dim=(2, 3), keepdim=True)
    hi = img.amax(dim=(2, 3), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    return torch.where(hi > lo, (img - lo) * scale, img)


def equalize(img, level, sign):
    """PIL's ImageOps.equalize integer LUT, per image and channel."""
    n, ch, h, w = img.shape
    u8 = _to_u8(img).to(torch.int64).reshape(n * ch, h * w)
    rows = torch.arange(n * ch, device=img.device).unsqueeze(1) * 256
    hist = torch.bincount((u8 + rows).reshape(-1),
                          minlength=n * ch * 256).reshape(n * ch, 256)
    bins = torch.arange(256, device=img.device)
    last_nz = torch.where(hist > 0, bins, torch.full_like(bins, -1)).amax(
        dim=1, keepdim=True)
    step = (hist.sum(dim=1, keepdim=True)
            - hist.gather(1, last_nz)) // 255
    offsets = torch.cumsum(hist, dim=1) - hist
    lut = torch.where(step > 0,
                      (step // 2 + offsets) // step.clamp(min=1),
                      bins.expand(n * ch, 256)).clamp(0, 255)
    out = lut.gather(1, u8).to(img.dtype) / 255.0
    return out.reshape(n, ch, h, w)


def posterize(img, level, sign):
    bits_kept = 4 - _int_parameter(level, 4)
    step = torch.pow(2.0, 8.0 - bits_kept).reshape(-1, 1, 1, 1)
    return (torch.floor(_to_u8(img) / step) * step) / 255.0


def rotate(img, level, sign):
    return _rotate(img, _signed(sign, _int_parameter(level, 30)))


def solarize(img, level, sign):
    threshold = ((256.0 - _int_parameter(level, 256)) / 255.0).reshape(
        -1, 1, 1, 1)
    return torch.where(img >= threshold, 1.0 - img, img)


def _constants(level: torch.Tensor):
    return torch.ones_like(level), torch.zeros_like(level)


def shear_x(img, level, sign):
    one, zero = _constants(level)
    s = _signed(sign, _float_parameter(level, 0.3))
    return _affine(img, one, s, zero, zero, one, zero)


def shear_y(img, level, sign):
    one, zero = _constants(level)
    s = _signed(sign, _float_parameter(level, 0.3))
    return _affine(img, one, zero, zero, s, one, zero)


def translate_x(img, level, sign):
    one, zero = _constants(level)
    t = _signed(sign, _int_parameter(level, IMAGE_SIZE / 3))
    return _affine(img, one, zero, t, zero, one, zero)


def translate_y(img, level, sign):
    one, zero = _constants(level)
    t = _signed(sign, _int_parameter(level, IMAGE_SIZE / 3))
    return _affine(img, one, zero, zero, zero, one, t)


def _enh_factor(level: torch.Tensor) -> torch.Tensor:
    return (_float_parameter(level, 1.8) + 0.1).reshape(-1, 1, 1, 1)


def color(img, level, sign):
    return _blend(_grayscale(img).expand_as(img), img, _enh_factor(level))


def contrast(img, level, sign):
    """PIL: blend with solid gray at the rounded mean of the L image."""
    mean = torch.round(_grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
                       * 255.0) / 255.0
    return _blend(mean.expand_as(img), img, _enh_factor(level))


def brightness(img, level, sign):
    return _blend(torch.zeros_like(img), img, _enh_factor(level))


def sharpness(img, level, sign):
    """PIL's SMOOTH kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 over the
    edge-replicated image; the one-pixel border keeps its values."""
    n, ch, h, w = img.shape
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          dtype=img.dtype, device=img.device) / 13.0
    pad = torch.nn.functional.pad(img.reshape(n * ch, 1, h, w),
                                  (1, 1, 1, 1), mode="replicate")
    smooth = torch.nn.functional.conv2d(pad, kernel[None, None]).reshape(
        n, ch, h, w)
    border = torch.ones(h, w, dtype=torch.bool, device=img.device)
    border[1:-1, 1:-1] = False
    smooth = torch.where(border, img, smooth)
    return _blend(smooth, img, _enh_factor(level))


OPS = dict(zip(AUG_NAMES, (
    autocontrast, equalize, posterize, rotate, solarize, shear_x, shear_y,
    translate_x, translate_y, color, contrast, brightness, sharpness)))


def check_aug_ops(aug_ops: Sequence[str]) -> None:
    unknown = [name for name in aug_ops if name not in OPS]
    if unknown:
        raise ValueError(f"unknown AugMix ops {unknown}; expected names from "
                         f"{AUG_NAMES}")


def apply_chains(img: torch.Tensor, depth: torch.Tensor, op: torch.Tensor,
                 level: torch.Tensor, sign: torch.Tensor,
                 aug_ops: Sequence[str]) -> torch.Tensor:
    """One AugMix chain per image: img [N, 3, H, W] in [0, 1]; depth [N] in
    {1, 2, 3}; op [N, 3] indices into `aug_ops`; level [N, 3] and sign
    [N, 3], the draws of each slot. Slot j applies op[:, j] where
    j < depth. The index lists of each (slot, op) are made on the host
    (one copy of depth and op, a wait for the device on a card)."""
    check_aug_ops(aug_ops)
    picks = torch.where(torch.arange(CHAIN_SLOTS, device=op.device)
                        < depth.unsqueeze(1), op, -1).cpu()
    out = img.clone()
    for slot in range(CHAIN_SLOTS):
        for o, name in enumerate(aug_ops):
            rows = torch.nonzero(picks[:, slot] == o)[:, 0]
            if rows.numel() == 0:
                continue
            rows = rows.to(img.device)
            out[rows] = OPS[name](out[rows], level[rows, slot],
                                  sign[rows, slot])
    return out
