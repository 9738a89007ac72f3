"""Architecture registry: the rows of `ttl_tpu/models/zoo.py`.

The ResNet rows (RN50 ... RN50x64, `models/resnet.py`) serve the prompt,
text-LoRA, CoCoOp and zero-shot modes; image-LoRA adapts ViT towers only, as
in the reference. The x4/x16/x64 scalings follow the published CLIP model
zoo. EVA02-CLIP-L-14-336 (`models/eva02.py`) is EVA-CLIP's
`EVA02-CLIP-L-14-336.json`: its vision tower at 336 px (577 tokens, a
2730-wide SwiGLU MLP, RoPE interpolated from a 16- to a 24-patch grid) and
OpenCLIP's text tower with the exact GELU. AIMv2-L-14-224-LiT
(`models/aimv2.py`) is `apple/aimv2-large-patch14-224-lit`
(https://huggingface.co/apple/aimv2-large-patch14-224-lit), the shapes of
transformers' `Aimv2Config` defaults: a vision tower of 24 RMSNorm,
bias-free SwiGLU blocks (2816 wide) with 8 heads of 128 at 224 px (256
tokens, no class token) and an attention-pooling head, and a 12-layer text
tower of the same block (768 wide, 6 heads of 128, SwiGLU 2048), both
projected to 512. The int8 prefix, the model axis and `--checkpoint_path`
raise ValueError on the EVA02 and AIMv2 towers.
"""
from __future__ import annotations

from .aimv2 import AIMv2TextConfig, AIMv2VisionConfig
from .clip import CLIPConfig, GELUTextConfig, TextConfig, VisionConfig
from .eva02 import EVA02VisionConfig
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

ARCHS["EVA02-CLIP-L-14-336"] = CLIPConfig(
    vision=EVA02VisionConfig(hidden=1024, layers=24, heads=16, proj_dim=768,
                             patch=14, image_size=336,
                             mlp_hidden=int(1024 * 2.6667),
                             rope_pretrain_grid=16),
    text=GELUTextConfig(hidden=768, layers=12, heads=12, proj_dim=768),
)

ARCHS["AIMv2-L-14-224-LiT"] = CLIPConfig(
    vision=AIMv2VisionConfig(hidden=1024, layers=24, heads=8, proj_dim=512,
                             patch=14, image_size=224, mlp_hidden=2816),
    text=AIMv2TextConfig(hidden=768, layers=12, heads=6, proj_dim=512,
                         mlp_hidden=2048),
)

# tiny config for tests and CPU runs (also an arch name: --arch test-tiny)
TEST_TINY = CLIPConfig(
    vision=VisionConfig(hidden=32, layers=4, heads=2, proj_dim=16,
                        patch=16, image_size=64),
    text=TextConfig(hidden=32, layers=4, heads=2, proj_dim=16,
                    vocab=49408, ctx=77),
)

ARCHS["test-tiny"] = TEST_TINY

# the EVA02 tower at tiny size (--arch eva02-tiny): a 4 x 4 grid whose RoPE
# positions are interpolated from a 2 x 2 one, an odd SwiGLU width
EVA02_TINY = CLIPConfig(
    vision=EVA02VisionConfig(hidden=32, layers=4, heads=2, proj_dim=16,
                             patch=16, image_size=64,
                             mlp_hidden=int(32 * 2.6667),
                             rope_pretrain_grid=2),
    text=GELUTextConfig(hidden=32, layers=4, heads=2, proj_dim=16),
)

ARCHS["eva02-tiny"] = EVA02_TINY

# the AIMv2 towers at tiny size (--arch aimv2-tiny): heads of 128, as at
# L/14, over a 4 x 4 grid
AIMV2_TINY = CLIPConfig(
    vision=AIMv2VisionConfig(hidden=256, layers=4, heads=2, proj_dim=16,
                             patch=16, image_size=64, mlp_hidden=704),
    text=AIMv2TextConfig(hidden=256, layers=4, heads=2, proj_dim=16,
                         mlp_hidden=704),
)

ARCHS["aimv2-tiny"] = AIMV2_TINY


def get_arch(name: str) -> CLIPConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
