"""CLIP ModifiedResNet vision towers (RN50 family) as plain functions.

Counterpart of `ttl_tpu/models/resnet.py` (the reference's clip/model.py:
Bottleneck, AttentionPool2d, ModifiedResNet): a 3-conv stem with an average
pool, anti-aliased strided blocks (a stride-2 block is conv + 2x2 average
pool) and an attention-pool head. Inference only: each batchnorm folds its
running statistics into an f32 scale and shift. The tower is frozen in every
mode; LoRA attaches only to the ViT towers, as in the reference.

Layout: NCHW activations, conv kernels OIHW as `F.conv2d` takes them, linear
weights [in, out]. The JAX package stores conv kernels HWIO; the weight
bridge (`models/convert.py`) moves them both ways, and checkpoints convert
to the JAX package's layout first (`convert_openai_resnet`), so that both
packages read each other's `.npz` caches.

Numerics follow the JAX tower: convolutions in the compute dtype; batchnorm
in f32, rounded once to the activation dtype; the 2x2 average pool sums its
taps one at a time in row-major order in the activation dtype, then divides
by 4, the order in which XLA's `reduce_window` sums them (bf16 agrees bit
for bit); the attention pool's projections, scores and softmax in f32. No
Pallas kernel is on this tower in the JAX package, and none is here: the
convolutions are `F.conv2d` (cuDNN on the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetVisionConfig:
    layers: Tuple[int, int, int, int]   # blocks per stage, RN50 = (3,4,6,3)
    width: int                          # stem width, RN50 = 64
    heads: int                          # attnpool heads = width * 32 // 64
    proj_dim: int                       # output embed dim
    image_size: int = 224

    @property
    def feat_dim(self) -> int:
        return self.width * 32  # stage4 channels = width * 8 * expansion(4)


RESNET_ARCHS = {
    "RN50": ResNetVisionConfig(layers=(3, 4, 6, 3), width=64, heads=32,
                               proj_dim=1024),
    "RN101": ResNetVisionConfig(layers=(3, 4, 23, 3), width=64, heads=32,
                                proj_dim=512),
    # EfficientNet-style scale-ups (published CLIP zoo)
    "RN50x4": ResNetVisionConfig(layers=(4, 6, 10, 6), width=80, heads=40,
                                 proj_dim=640, image_size=288),
    "RN50x16": ResNetVisionConfig(layers=(6, 8, 18, 8), width=96, heads=48,
                                  proj_dim=768, image_size=384),
    "RN50x64": ResNetVisionConfig(layers=(3, 15, 36, 10), width=128,
                                  heads=64, proj_dim=1024, image_size=448),
}


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Convolution with (k - 1) // 2 zero padding on each side, as torch's
    layers pad (XLA's "SAME" would pad asymmetrically under stride 2)."""
    return F.conv2d(x, w.to(x.dtype), stride=stride,
                    padding=(w.shape[2] - 1) // 2)


def _bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Inference batchnorm: y = (x - mean) / sqrt(var + eps) * g + b, folded
    into one scale and shift in f32."""
    scale = p["scale"].float() / torch.sqrt(p["var"].float() + 1e-5)
    shift = p["bias"].float() - p["mean"].float() * scale
    return (x.float() * scale[None, :, None, None]
            + shift[None, :, None, None]).to(x.dtype)


def _avgpool2(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k average pool at stride k (no padding): the taps added one at a
    time in row-major order in x's dtype, then divided by k * k."""
    h, w = (x.shape[2] // k) * k, (x.shape[3] // k) * k
    total = x[:, :, 0:h:k, 0:w:k]
    for i in range(k):
        for j in range(k):
            if i or j:
                total = total + x[:, :, i:h:k, j:w:k]
    return total / (k * k)


def bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """1x1 -> 3x3 -> (average pool where strided) -> 1x1 x4; the shortcut
    is an average pool and a 1x1 conv where the block's params carry a
    `downsample`."""
    out = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = F.relu(_bn(_conv(out, p["conv2"]), p["bn2"]))
    if stride > 1:
        out = _avgpool2(out, stride)
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        idn = _avgpool2(x, stride) if stride > 1 else x
        idn = _bn(_conv(idn, p["downsample"]["conv"]), p["downsample"]["bn"])
    else:
        idn = x
    return F.relu(out + idn)


def attention_pool(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Flatten the grid, prepend the mean token, add the position embedding
    (cast to the tokens' dtype first), and one attention layer queried by
    the mean token alone: the projections, scores and softmax in f32.
    x [N, C, H, W] -> [N, proj_dim] f32."""
    n, c, h, w = x.shape
    tokens = x.reshape(n, c, h * w).transpose(1, 2)           # [N, HW, C]
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = (tokens + p["pos_embed"].to(tokens.dtype)).float()

    def proj(t, name):
        return t @ p[name]["w"].float() + p[name]["b"].float()

    hd = c // heads

    def split(t):
        return t.reshape(n, -1, heads, hd).transpose(1, 2)

    q = split(proj(tokens[:, :1], "q"))
    k, v = split(proj(tokens, "k")), split(proj(tokens, "v"))
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
    out = torch.softmax(scores, dim=-1) @ v                   # [N, H, 1, hd]
    return proj(out.transpose(1, 2).reshape(n, c), "out")


def resnet_features(p: Params, images: torch.Tensor, cfg: ResNetVisionConfig,
                    *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[B, 3, H, W] CLIP-normalized -> [B, proj_dim] f32, unnormalized."""
    x = images.to(compute_dtype)
    for i in (1, 2, 3):
        x = F.relu(_bn(_conv(x, p[f"conv{i}"], stride=2 if i == 1 else 1),
                       p[f"bn{i}"]))
    x = _avgpool2(x, 2)
    for stage in range(4):
        for b, bp in enumerate(p[f"layer{stage + 1}"]):
            x = bottleneck(bp, x, stride=2 if b == 0 and stage > 0 else 1)
    return attention_pool(p["attnpool"], x, cfg.heads).float()


# ------------------------------------------------------------------ convert

def convert_openai_resnet(sd, cfg: ResNetVisionConfig,
                          param_dtype=np.float32) -> Params:
    """OpenAI RN50-family `visual.*` state dict -> numpy tree in the JAX
    package's layout (conv kernels HWIO; `models.convert.params_from_numpy`
    makes them OIHW): conv1-3/bn1-3 stem, layer{1-4} lists of blocks,
    attnpool. Batchnorm and attention-pool leaves are f32, convs
    param_dtype."""
    def arr(k):
        v = sd[k]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def conv(k):  # torch OIHW -> HWIO
        return arr(k).transpose(2, 3, 1, 0).astype(param_dtype)

    def bn(prefix):
        return {"scale": arr(f"{prefix}.weight").astype(np.float32),
                "bias": arr(f"{prefix}.bias").astype(np.float32),
                "mean": arr(f"{prefix}.running_mean").astype(np.float32),
                "var": arr(f"{prefix}.running_var").astype(np.float32)}

    def linear(prefix):
        return {"w": arr(f"{prefix}.weight").T.astype(np.float32),
                "b": arr(f"{prefix}.bias").astype(np.float32)}

    p: Params = {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = conv(f"visual.conv{i}.weight")
        p[f"bn{i}"] = bn(f"visual.bn{i}")
    for stage in range(4):
        blocks = []
        for b in range(cfg.layers[stage]):
            pre = f"visual.layer{stage + 1}.{b}"
            bp = {"conv1": conv(f"{pre}.conv1.weight"), "bn1": bn(f"{pre}.bn1"),
                  "conv2": conv(f"{pre}.conv2.weight"), "bn2": bn(f"{pre}.bn2"),
                  "conv3": conv(f"{pre}.conv3.weight"), "bn3": bn(f"{pre}.bn3")}
            if f"{pre}.downsample.0.weight" in sd:
                # downsample = Sequential(("-1", avgpool), ("0", conv),
                # ("1", bn)): its state dict keys are 0 (conv) and 1 (bn)
                bp["downsample"] = {"conv": conv(f"{pre}.downsample.0.weight"),
                                    "bn": bn(f"{pre}.downsample.1")}
            blocks.append(bp)
        p[f"layer{stage + 1}"] = blocks
    p["attnpool"] = {
        "pos_embed": arr("visual.attnpool.positional_embedding"
                         ).astype(np.float32),
        **{n: linear(f"visual.attnpool.{n}_proj") for n in "qkv"},
        "out": linear("visual.attnpool.c_proj"),
    }
    return p


def init_resnet_params(cfg: ResNetVisionConfig, gen: torch.Generator, *,
                       device, param_dtype=torch.float32) -> Params:
    """Random weights in the JAX package's distributions, drawn from `gen`
    on the host: He-normal convs (OIHW) in param_dtype, identity
    batchnorms, and the attention pool in f32 whatever param_dtype is."""
    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))
        w = torch.randn(cout, cin, kh, kw, generator=gen) * std
        return w.to(device=device, dtype=param_dtype)

    def bn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device),
                "mean": torch.zeros(c, device=device),
                "var": torch.ones(c, device=device)}

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)

    def linear(d_in, d_out):
        return {"w": normal(d_in, d_out, std=0.02),
                "b": torch.zeros(d_out, device=device)}

    w = cfg.width
    p: Params = {"conv1": conv(3, 3, 3, w // 2), "bn1": bn(w // 2),
                 "conv2": conv(3, 3, w // 2, w // 2), "bn2": bn(w // 2),
                 "conv3": conv(3, 3, w // 2, w), "bn3": bn(w)}
    cin = w
    for stage in range(4):
        cmid = w * (2 ** stage)
        cout = cmid * 4
        blocks = []
        for b in range(cfg.layers[stage]):
            bp = {"conv1": conv(1, 1, cin, cmid), "bn1": bn(cmid),
                  "conv2": conv(3, 3, cmid, cmid), "bn2": bn(cmid),
                  "conv3": conv(1, 1, cmid, cout), "bn3": bn(cout)}
            if b == 0:
                bp["downsample"] = {"conv": conv(1, 1, cin, cout),
                                    "bn": bn(cout)}
            blocks.append(bp)
            cin = cout
        p[f"layer{stage + 1}"] = blocks
    d = cfg.feat_dim
    spatial = (cfg.image_size // 32) ** 2
    p["attnpool"] = {"pos_embed": normal(spatial + 1, d, std=d ** -0.5),
                     **{n: linear(d, d) for n in "qkv"},
                     "out": linear(d, cfg.proj_dim)}
    return p
