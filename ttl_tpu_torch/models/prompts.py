"""Prompt token tables and the frozen text classifiers.

Counterpart of `prompt_tokens`, `needed_ctx_len`, `build_text_classifier`
and `build_ensemble_classifier` in `ttl_tpu/models/prompts.py`, on the JAX
package's BPE tokenizer. The 80 ImageNet templates are read from the JAX
package's asset file.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ttl_tpu.data import classnames as _classnames
from ttl_tpu.tokenizer.bpe import tokenize

from .clip import TextConfig, l2_normalize, text_features

TEMPLATES_FILE = (Path(_classnames.__file__).resolve().parent / "assets"
                  / "imagenet_templates.json")
ENSEMBLE_BATCH = 256  # prompts per text-tower call in the ensemble


def load_imagenet_templates() -> List[str]:
    return json.loads(TEMPLATES_FILE.read_text())


def format_prompts(classnames: Sequence[str],
                   template: str = "a photo of a {}.") -> list[str]:
    """Underscores in class names become spaces."""
    return [template.format(c.replace("_", " ")) for c in classnames]


def prompt_tokens(classnames: Sequence[str],
                  prompt_prefix: str = "a photo of a") -> np.ndarray:
    """[C, 77] int32 token table for '<prefix> <classname>.'; braces in the
    prefix tokenize literally."""
    safe = prompt_prefix.replace("{", "{{").replace("}", "}}")
    return tokenize(format_prompts(classnames, safe + " {}."))


def needed_ctx_len(tokens, multiple: int = 16) -> int:
    """Context length a table needs: the text tower is causal and pools at
    the EOT (the largest id), so positions past the longest EOT are dead.
    Rounded up to `multiple`, capped at the table's width; exact."""
    tokens = np.asarray(tokens)
    eot = int(tokens.argmax(axis=-1).max())
    return min(-(-(eot + 1) // multiple) * multiple, int(tokens.shape[-1]))


@torch.no_grad()
def build_text_classifier(params, tokens, cfg: TextConfig, *, device,
                          compute_dtype=torch.bfloat16, batch: int = 256,
                          truncate: bool = True) -> torch.Tensor:
    """Encode a token table into an L2-normalized [C, proj_dim] classifier,
    `batch` prompts at a time."""
    tokens = np.asarray(tokens)
    if truncate:
        tokens = tokens[:, : needed_ctx_len(tokens)]
    toks = torch.from_numpy(tokens.astype(np.int64)).to(device)
    feats = [text_features(params, toks[i: i + batch], cfg,
                           compute_dtype=compute_dtype)
             for i in range(0, toks.shape[0], batch)]
    return l2_normalize(torch.cat(feats, dim=0))


@torch.no_grad()
def build_ensemble_classifier(text_params, classnames: Sequence[str],
                              cfg: TextConfig, *, device,
                              templates: Optional[Sequence[str]] = None,
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The template ensemble (80 ImageNet templates by default): per class,
    the mean of its prompts' L2-normalized embeddings, renormalized ->
    [C, proj_dim]. Every prompt is cut at one global EOT length
    (needed_ctx_len; exact), and ENSEMBLE_BATCH prompts are encoded at a
    time."""
    templates = list(templates or load_imagenet_templates())
    tokens = np.concatenate([
        tokenize([t.format(c.replace("_", " ")) for t in templates])
        for c in classnames])
    tokens = tokens[:, : needed_ctx_len(tokens)]
    toks = torch.from_numpy(tokens.astype(np.int64)).to(device)
    batch = ENSEMBLE_BATCH
    emb = torch.cat([l2_normalize(text_features(
        text_params, toks[i: i + batch], cfg, compute_dtype=compute_dtype))
        for i in range(0, toks.shape[0], batch)])
    mean = emb.reshape(len(classnames), len(templates), -1).mean(dim=1)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
