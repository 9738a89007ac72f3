"""Prompt token tables, the frozen text classifiers and the prompt learner.

Counterpart of `ttl_tpu/models/prompts.py`: `prompt_tokens`,
`needed_ctx_len`, `build_text_classifier`, `build_ensemble_classifier`, and
the CoOp-style `PromptLearnerState` of the prompt-tuning (TPT) path, on the
port's own BPE tokenizer and template file.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..tokenizer.bpe import default_tokenizer, tokenize
from .clip import TextConfig, l2_normalize, text_features

TEMPLATES_FILE = (Path(__file__).resolve().parent.parent / "data" / "assets"
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


# ------------------------------------------------------------- PromptLearner

@dataclasses.dataclass
class PromptLearnerState:
    """CoOp prompt state of the prompt-tuning path: the tunable context
    block `ctx` [n_ctx, d] sits between the frozen SOS prefix embedding and
    the class-name + EOT suffix embeddings. `ctx_init` is the episodic reset
    state. With `cls` (learned_cls) a learnable one-token class vector
    replaces the class name."""
    ctx: torch.Tensor            # [n_ctx, d], trainable
    ctx_init: torch.Tensor       # snapshot for reset
    prefix: torch.Tensor         # [C, 1, d] SOS embedding
    suffix: torch.Tensor         # [C, L - 1 - n_ctx, d] class tokens, EOT, pad
    tokenized: torch.Tensor      # [C, L] int64, for EOT pooling (L <= 77)
    name_lens: torch.Tensor      # [C] class-name token counts
    n_ctx: int
    prompt_prefix: str
    ctx_position: str = "end"
    cls: Optional[torch.Tensor] = None        # [C, 1, d]
    cls_init: Optional[torch.Tensor] = None

    def assemble(self, ctx: Optional[torch.Tensor] = None,
                 cls: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prompt embeddings [C, L, d] with `ctx` (default: the state's)
        spliced in at the configured position. `ctx` may carry leading
        sample axes, [..., n_ctx, d] (and `cls` [..., C, 1, d]); the result
        is then [..., C, L, d]."""
        c = self.ctx if ctx is None else ctx
        cls = self.cls if cls is None else cls
        lead = c.shape[:-2]
        n_cls = self.prefix.shape[0]

        def per_class(t):   # [C, n, d] -> [..., C, n, d]
            return t.expand(*lead, *t.shape)

        ctx_block = c.unsqueeze(-3).expand(*lead, n_cls, *c.shape[-2:])
        prefix, suffix = per_class(self.prefix), per_class(self.suffix)
        if cls is not None:
            # learned_cls: [SOS | ctx | cls | suffix], 'end' position only
            cls = cls if cls.dim() == c.dim() + 1 else per_class(cls)
            return torch.cat([prefix, ctx_block.to(suffix.dtype),
                              cls.to(suffix.dtype), suffix], dim=-2)
        if self.ctx_position == "end":
            return torch.cat([prefix, ctx_block.to(suffix.dtype), suffix],
                             dim=-2)
        # middle/front: per class, a gather over [ctx | suffix] that puts
        # the class-name tokens before the ctx (front) or inside it (middle)
        half = self.n_ctx // 2
        pos = torch.arange(self.n_ctx + self.suffix.shape[1],
                           device=c.device).unsqueeze(0)        # [1, n]
        name = self.name_lens.to(c.device).unsqueeze(1)          # [C, 1]
        if self.ctx_position == "front":
            idx = torch.where(pos < name, self.n_ctx + pos,
                              torch.where(pos < name + self.n_ctx,
                                          pos - name, pos))
        else:
            idx = torch.where(
                pos < half, pos.expand(n_cls, -1),
                torch.where(pos < half + name, self.n_ctx + (pos - half),
                            torch.where(pos < self.n_ctx + name, pos - name,
                                        pos)))
        src = torch.cat([ctx_block.to(suffix.dtype), suffix], dim=-2)
        idx = idx.unsqueeze(-1).expand(*lead, *idx.shape, src.shape[-1])
        return torch.cat([prefix, torch.gather(src, -2, idx)], dim=-2)

    def reset(self) -> "PromptLearnerState":
        return dataclasses.replace(self, ctx=self.ctx_init,
                                   cls=self.cls_init)


def init_prompt_learner(token_embed: torch.Tensor, classnames: Sequence[str],
                        ctx_init: str = "a_photo_of_a",
                        ctx_position: str = "end",
                        learned_cls: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> PromptLearnerState:
    """Build the prompt-learner buffers from the frozen token embedding
    table (on its device). The ctx vectors are the embeddings of the init
    phrase, in f32. With `learned_cls` each class gets a random one-token
    vector (0.02 * normal, drawn on the host from `generator`) in place of
    its name. The dead positions past the longest EOT are dropped
    (needed_ctx_len; exact)."""
    tk = default_tokenizer()
    phrase = ctx_init.replace("_", " ")
    n_ctx = len(phrase.split(" "))
    phrase_ids = tk.encode(phrase)
    if len(phrase_ids) != n_ctx:
        raise ValueError("multi-token words unsupported in ctx_init")
    if learned_cls and ctx_position != "end":
        raise ValueError("learned_cls requires ctx_position='end'")
    device = token_embed.device
    n_cls = len(classnames)
    if learned_cls:
        toks = np.asarray(tokenize([f"{phrase} X." for _ in classnames]))
    else:
        toks = prompt_tokens(classnames, phrase)
    ctx_len = needed_ctx_len(toks)
    toks = torch.from_numpy(toks[:, :ctx_len].astype(np.int64)).to(device)
    embedding = token_embed[toks]                       # [C, ctx_len, d]
    if learned_cls:
        gen = generator or torch.Generator().manual_seed(0)
        cls_vec = (0.02 * torch.randn(n_cls, 1, token_embed.shape[-1],
                                      generator=gen)).to(device)
        suffix = embedding[:, 1 + n_ctx + 1:]           # skip the X slot
        name_lens = torch.ones(n_cls, dtype=torch.int64, device=device)
    else:
        cls_vec = None
        suffix = embedding[:, 1 + n_ctx:]
        name_lens = torch.tensor(
            [len(tk.encode(c.replace("_", " "))) for c in classnames],
            dtype=torch.int64, device=device)
    ctx = token_embed[torch.tensor(phrase_ids, device=device)].float()
    return PromptLearnerState(
        ctx=ctx, ctx_init=ctx, prefix=embedding[:, :1], suffix=suffix,
        tokenized=toks, name_lens=name_lens, n_ctx=n_ctx,
        prompt_prefix=phrase, ctx_position=ctx_position, cls=cls_vec,
        cls_init=cls_vec)
