"""Prompt token tables and the frozen text classifier.

Counterpart of `prompt_tokens`, `needed_ctx_len` and `build_text_classifier`
in `ttl_tpu/models/prompts.py`, on the JAX package's BPE tokenizer.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ttl_tpu.tokenizer.bpe import tokenize

from .clip import TextConfig, l2_normalize, text_features


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
