"""Offline analysis and visualization.

Counterpart of `ttl_tpu/utils/analysis.py` (the reference's attention
rollout, functions.py:88-104; heatmap overlay, 107-127; t-SNE feature plots,
131-162). Not on the hot path: the attention maps are explicit scores and a
softmax, as the JAX function computes them, since no kernel hands out its
probabilities. The overlay's jet colours are computed here (the card's
machine has no matplotlib); sklearn, and matplotlib for t-SNE's plot, are
imported lazily. The outputs are tensors, arrays or saved files.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.clip import (VisionConfig, layer_at, layer_norm, linear,
                           quick_gelu)
from ..ops.image import resize_bilinear


@torch.no_grad()
def vision_attention_maps(p, images: torch.Tensor, cfg: VisionConfig,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Run the ViT tower over images [B, 3, H, W] and keep every layer's
    attention probabilities: [L, B, H, S, S] f32."""
    b = images.shape[0]
    g, pt = cfg.grid, cfg.patch
    x = images.to(compute_dtype)
    x = x.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * pt * pt)
    x = torch.matmul(x, p["patch_embed"].to(compute_dtype))
    cls = p["class_embed"].to(compute_dtype).expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"].to(compute_dtype)
    x = layer_norm(x, p["ln_pre"], cfg.ln_eps)
    s, hd = x.shape[1], cfg.hidden // cfg.heads

    def split(t):
        return t.reshape(b, s, cfg.heads, hd).transpose(1, 2)

    maps = []
    for i in range(cfg.layers):
        lp = layer_at(p["layers"], i)
        h = layer_norm(x, lp["ln1"], cfg.ln_eps)
        q, k, v = (split(linear(h, lp["attn"][n])) for n in "qkv")
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(hd)
        w = torch.softmax(scores, dim=-1)
        maps.append(w)
        out = torch.matmul(w.to(v.dtype), v).transpose(1, 2)
        x = x + linear(out.reshape(b, s, cfg.hidden), lp["attn"]["o"])
        h = layer_norm(x, lp["ln2"], cfg.ln_eps)
        x = x + linear(quick_gelu(linear(h, lp["mlp"]["fc1"])),
                       lp["mlp"]["fc2"])
    return torch.stack(maps)


def attention_rollout(attn_maps: torch.Tensor,
                      discard_ratio: float = 0.0) -> torch.Tensor:
    """Abnar & Zuidema rollout: average the heads, add the residual
    identity, renormalize, multiply through the layers. attn_maps
    [L, B, H, S, S] -> CLS-to-patch relevance [B, S-1], max 1 a row. With
    `discard_ratio`, the values below the k-th smallest of each layer's map
    (k = int(S*S*ratio)) are zeroed; values equal to it stay."""
    l, b, _, s, _ = attn_maps.shape
    a = attn_maps.mean(dim=2)                                  # [L, B, S, S]
    if discard_ratio > 0:
        k = int(s * s * discard_ratio)
        flat = a.reshape(l, b, -1)
        thresh = flat.sort(dim=-1).values[..., k:k + 1]
        a = torch.where(flat < thresh, torch.zeros_like(flat),
                        flat).reshape(l, b, s, s)
    eye = torch.eye(s, dtype=a.dtype, device=a.device)
    a = a + eye
    a = a / a.sum(dim=-1, keepdim=True)
    rollout = eye.expand(b, s, s)
    for layer in a:
        rollout = torch.matmul(layer, rollout)
    cls_rel = rollout[:, 0, 1:]
    return cls_rel / cls_rel.max(dim=-1, keepdim=True).values


# matplotlib's jet colormap (`matplotlib._cm._jet_data`): per channel, the
# points (x, y) of a piecewise-linear map of [0, 1]
_JET = {"red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0),
                (1.0, 0.5)),
        "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
                  (0.91, 0.0), (1.0, 0.0)),
        "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0),
                 (1.0, 0.0))}
JET_LEVELS = 256


def jet(x: np.ndarray) -> np.ndarray:
    """`matplotlib.cm.jet(x)[..., :3]` for x in [0, 1], without matplotlib:
    the map sampled at 256 levels, x * 256 (in x's dtype) floored to its
    level, x = 1 at the top one."""
    levels = np.linspace(0.0, 1.0, JET_LEVELS)
    lut = np.stack([np.interp(levels, *zip(*_JET[c]))
                    for c in ("red", "green", "blue")], axis=-1)
    scaled = np.array(x, copy=True) * JET_LEVELS
    scaled[scaled == JET_LEVELS] = JET_LEVELS - 1
    return lut[np.clip(scaled, 0, JET_LEVELS - 1).astype(int)]


def heatmap_overlay(image01: np.ndarray, relevance: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """Overlay a [P] patch-relevance map onto an [H, W, 3] image in [0, 1]
    (the reference without cv2), in matplotlib's jet colours (`jet`). The
    map is resized as `jax.image.resize(..., "bilinear")` resizes it
    (`ops.image.resize_bilinear`), so that a value near a boundary of the
    colormap's 256 levels takes the JAX package's colour."""
    h, w = image01.shape[:2]
    g = int(round(np.sqrt(relevance.shape[-1])))
    rel = torch.from_numpy(np.array(relevance, np.float32)).reshape(g, g)
    rel = resize_bilinear(rel, (h, w)).numpy()
    rel = (rel - rel.min()) / max(rel.max() - rel.min(), 1e-8)
    return np.clip((1 - alpha) * image01 + alpha * jet(rel), 0, 1)


def tsne_features(features: np.ndarray, labels: Sequence[int],
                  out_path: Optional[str] = None, perplexity: float = 30.0):
    """2-D t-SNE of feature vectors, optionally saved as a scatter plot."""
    from sklearn.manifold import TSNE

    emb = TSNE(n_components=2,
               perplexity=min(perplexity, max(len(features) - 1, 1) / 3),
               init="pca", random_state=0).fit_transform(
        np.asarray(features, np.float32))
    if out_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=list(labels), cmap="tab10",
                        s=12)
        fig.colorbar(sc, ax=ax)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return emb
