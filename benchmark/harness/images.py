"""Synthetic JPEG test images, made from the run's seed.

Every seed gets the same set of image sizes, in its own order, so that the
decode and upload work of a run does not depend on the seed: the long side
runs evenly over [long_min, long_max] px and the aspect (width / height)
evenly over [3/4, 4/3], the two paired by a fixed stride. The content is
smooth and photo-like, not white noise: a coarse colour field, a finer
texture and a little grain, so that a JPEG decodes at what a photo costs.
"""
from __future__ import annotations

import io
import os
from typing import List, Tuple

import numpy as np
from PIL import Image

QUALITY = 90
ASPECTS = (3.0 / 4.0, 4.0 / 3.0)


def sizes(n: int, long_min: int, long_max: int) -> List[Tuple[int, int]]:
    """The n (width, height) pairs every seed shares."""
    out = []
    for k in range(n):
        long_side = round(long_min + (long_max - long_min) * (k + 0.5) / n)
        j = (k * 37 + 11) % n
        aspect = ASPECTS[0] * (ASPECTS[1] / ASPECTS[0]) ** ((j + 0.5) / n)
        if aspect >= 1.0:
            out.append((long_side, max(1, round(long_side / aspect))))
        else:
            out.append((max(1, round(long_side * aspect)), long_side))
    return out


def _field(rng, cells: int, w: int, h: int, scale: float) -> np.ndarray:
    coarse = rng.uniform(0.0, 255.0, (cells, cells, 3)).astype(np.uint8)
    img = Image.fromarray(coarse).resize((w, h), Image.BICUBIC)
    return (np.asarray(img, np.float32) - 127.5) * scale


def jpeg(rng: np.random.Generator, w: int, h: int) -> bytes:
    x = 127.5 + _field(rng, 5, w, h, 0.9) + _field(rng, 24, w, h, 0.25)
    x += 3.0 * rng.standard_normal((h, w, 1), dtype=np.float32)
    buf = io.BytesIO()
    Image.fromarray(np.clip(x, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=QUALITY)
    return buf.getvalue()


def write_set(seed: int, n: int, long_min: int, long_max: int,
              directory: str) -> List[str]:
    """n JPEG files in `directory`; the seed orders the shared sizes and
    draws the content."""
    rng = np.random.default_rng([seed, 0x4A50])
    order = rng.permutation(n)
    shared = sizes(n, long_min, long_max)
    paths = []
    for k in range(n):
        w, h = shared[order[k]]
        path = os.path.join(directory, f"img{k:04d}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg(rng, w, h))
        paths.append(path)
    return paths


def decode(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB, as the program's loader and server decode."""
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)
