"""The reference's answers for a set of test images, in blocks.

Each item is (key, JPEG path, draw index): the reference decodes the file
itself (PIL, as the program's loader and server do), places it at the top
left of a square zero canvas, renders its views from the run's seed and
the item's draw index, and computes its adapted and zero-shot logits with
weights it draws itself from the seed. What belongs to the configuration's
architecture (its towers, weight draw, image normalization and, where it
has its own, prompt table) comes from the module `arch` the harness finds
by the configuration's `architecture` key (`reference/arch/<name>.py`).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from . import model, views
from .tokenizer import prompt_table


def canvas_of(path: str, canvas: int) -> Tuple[np.ndarray, int, int]:
    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), np.uint8)
    h, w = arr.shape[:2]
    if max(h, w) > canvas:
        raise ValueError(f"{path}: {w}x{h} exceeds the {canvas}-px canvas; "
                         "the benchmark's images fit it")
    out = np.zeros((canvas, canvas, 3), np.uint8)
    out[:h, :w] = arr
    return out, h, w


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def logits(config: dict, seed: int, classnames: Sequence[str],
           items: Sequence[tuple], *, arch, device, canvas: int, block: int,
           arithmetic: str = "exact") -> Dict[object, tuple]:
    """key -> (adapted logits [C], zero-shot logits [C]) as float32 host
    tensors, under the architecture module `arch`. `arithmetic` "fp8"
    rounds every product's operands to float8 (the control)."""
    mm = getattr(model, arithmetic)
    model.f32_products()
    params = to_device(arch.draw_weights(config, seed), device)
    table = getattr(arch, "prompt_table", prompt_table)
    tokens = torch.from_numpy(table(
        classnames, config["ttl"]["prompt_template"])).to(device)
    with torch.no_grad():
        classes = model.normalize(arch.text_classifier(
            params["text"], tokens, config["text"], mm=mm))
    adapters0 = to_device(arch.draw_adapters(config, seed), device)
    size = config["vision"]["image_size"]
    n_views = config["ttl"]["views"]
    out = {}
    for start in range(0, len(items), block):
        chunk = items[start:start + block]
        placed = [canvas_of(path, canvas) for _, path, _ in chunk]
        canv = torch.from_numpy(np.stack([p[0] for p in placed])).to(device)
        hs = torch.tensor([p[1] for p in placed], device=device)
        ws = torch.tensor([p[2] for p in placed], device=device)
        draws = {k: t.to(device) for k, t in views.draw_many(
            seed, [d for _, _, d in chunk], n_views).items()}
        v = views.render(canv, hs, ws, draws, size, arch.IMAGE_MEAN,
                         arch.IMAGE_STD)
        a, z = model.ttl_logits(arch, params, config, v, classes, adapters0,
                                mm)
        for (key, _, _), ai, zi in zip(chunk, a.cpu(), z.cpu()):
            out[key] = (ai, zi)
    return out
