"""Top-k counts on the device (single device).

Counterpart of the single-device `make_count_fn` in
`ttl_tpu/parallel/eval.py`; the multi-device reduction comes with
multi-GPU support (ROADMAP Queue 1, item 17).
"""
from __future__ import annotations

from typing import Sequence

import torch


def topk_counts(logits: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, topk: Sequence[int] = (1, 5)
                ) -> torch.Tensor:
    """(logits [S, C], labels [S], valid [S] bool) -> int32 [len(topk)+1]:
    per-k counts of valid rows whose label is among the k highest logits,
    then the number of valid rows."""
    ks = min(max(topk), logits.shape[-1])
    # a stable sort of the negated logits: equal logits go to the lower
    # index, as jax.lax.top_k orders them (torch.topk promises no order)
    pred = torch.argsort(-logits.float(), dim=-1, stable=True)[:, :ks]
    hit = (pred == labels[:, None]) & valid[:, None]
    per_k = [hit[:, :k].any(dim=1).sum() for k in topk]
    return torch.stack(per_k + [valid.sum()]).to(torch.int32)
