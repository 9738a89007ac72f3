"""Architecture registry: the ViT rows of `ttl_tpu/models/zoo.py`.

The ResNet rows (RN50 ... RN50x64) are known names that raise
NotImplementedError until their towers are ported (ROADMAP Queue 1, item 14).
"""
from __future__ import annotations

from .clip import CLIPConfig, TextConfig, VisionConfig

RESNET_ARCHS = ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64")

ARCHS = {
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
    if name in RESNET_ARCHS:
        raise NotImplementedError(
            f"arch {name!r}: the ResNet towers are not ported yet "
            "(ROADMAP Queue 1, item 14)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
