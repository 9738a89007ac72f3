"""Architecture registry: the rows of `ttl_tpu/models/zoo.py`.

The ResNet rows (RN50 ... RN50x64, `models/resnet.py`) serve the prompt,
text-LoRA, CoCoOp and zero-shot modes; image-LoRA adapts ViT towers only, as
in the reference. The x4/x16/x64 scalings follow the published CLIP model
zoo.
"""
from __future__ import annotations

from .clip import CLIPConfig, TextConfig, VisionConfig
from .resnet import RESNET_ARCHS

ARCHS = {
    "RN50": CLIPConfig(
        vision=RESNET_ARCHS["RN50"],
        text=TextConfig(hidden=512, layers=12, heads=8, proj_dim=1024),
    ),
    "RN101": CLIPConfig(
        vision=RESNET_ARCHS["RN101"],
        text=TextConfig(hidden=512, layers=12, heads=8, proj_dim=512),
    ),
    "RN50x4": CLIPConfig(
        vision=RESNET_ARCHS["RN50x4"],
        text=TextConfig(hidden=640, layers=12, heads=10, proj_dim=640),
    ),
    "RN50x16": CLIPConfig(
        vision=RESNET_ARCHS["RN50x16"],
        text=TextConfig(hidden=768, layers=12, heads=12, proj_dim=768),
    ),
    "RN50x64": CLIPConfig(
        vision=RESNET_ARCHS["RN50x64"],
        text=TextConfig(hidden=1024, layers=12, heads=16, proj_dim=1024),
    ),
    "ViT-B/16": CLIPConfig(
        vision=VisionConfig(hidden=768, layers=12, heads=12, proj_dim=512,
                            patch=16, image_size=224),
        text=TextConfig(hidden=512, layers=12, heads=8, proj_dim=512),
    ),
    "ViT-B/32": CLIPConfig(
        vision=VisionConfig(hidden=768, layers=12, heads=12, proj_dim=512,
                            patch=32, image_size=224),
        text=TextConfig(hidden=512, layers=12, heads=8, proj_dim=512),
    ),
    "ViT-L/14": CLIPConfig(
        vision=VisionConfig(hidden=1024, layers=24, heads=16, proj_dim=768,
                            patch=14, image_size=224),
        text=TextConfig(hidden=768, layers=12, heads=12, proj_dim=768),
    ),
    "ViT-L/14@336px": CLIPConfig(
        vision=VisionConfig(hidden=1024, layers=24, heads=16, proj_dim=768,
                            patch=14, image_size=336),
        text=TextConfig(hidden=768, layers=12, heads=12, proj_dim=768),
    ),
}

# tiny config for tests and CPU runs (also an arch name: --arch test-tiny)
TEST_TINY = CLIPConfig(
    vision=VisionConfig(hidden=32, layers=4, heads=2, proj_dim=16,
                        patch=16, image_size=64),
    text=TextConfig(hidden=32, layers=4, heads=2, proj_dim=16,
                    vocab=49408, ctx=77),
)

ARCHS["test-tiny"] = TEST_TINY


def get_arch(name: str) -> CLIPConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
