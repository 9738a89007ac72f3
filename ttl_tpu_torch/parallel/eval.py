"""Top-k counts, and evaluation over a mesh of processes.

Counterpart of `ttl_tpu/parallel/eval.py`. Each model group (one process a
card; `parallel/mesh.py`) runs the batched step over its data index's rows
of the sample batch; on a model axis its ranks split the towers' heads and
MLP columns and the classifier's classes (`parallel/tensor.py`). The
traffic over the data axis is on the host: the three counts a batch summed
over the data group, and, in `make_sharded_ttl_fn`, the logits gathered
over it so that every rank holds the whole batch's.

Those collectives go over gloo on CPU tensors (the runner's launcher
initializes the default group with gloo): NCCL refuses two ranks on one
card, which is how the one-card smoke shows the axes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..adapt.ttl import AdaptResult, make_batched_ttl_fn
from ..config import TTLConfig
from ..models.clip import CLIPConfig, tree_map
from .mesh import Mesh, world_and_rank


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


def _group_size(group) -> int:
    if world_and_rank()[0] == 1:
        return 1
    return dist.get_world_size(group)


def sum_over_ranks(counts: torch.Tensor, group=None) -> torch.Tensor:
    """int counts summed over every rank of `group` (None: the default
    group), on the CPU (waits for the device); the counts themselves, where
    they are, when the group has one process. On a model axis pass the data
    group: the ranks of a model group hold the same counts."""
    if _group_size(group) == 1:
        return counts
    total = counts.cpu().to(torch.int64)
    dist.all_reduce(total, group=group)
    return total.to(counts.dtype)


def make_count_fn(mesh: Optional[Mesh] = None, topk=(1, 5)):
    """(logits [S, C], labels [S], valid [S]) -> int32 [len(topk)+1]:
    per-k correct counts over the valid rows plus the valid count. With a
    mesh of more than one process, each rank passes its data index's rows
    and gets the sums over the data axis, on the CPU."""
    def counts(logits, labels, valid):
        c = topk_counts(logits, labels, valid, topk)
        return c if mesh is None else sum_over_ranks(c, mesh.data_group)
    return counts


def sharded_topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                         topk=(1, 5)) -> torch.Tensor:
    """This rank's rows of [S, C] logits and [S] labels -> the correct
    counts per k summed over every rank (int32 [len(topk)]; on the CPU
    when there are several ranks)."""
    valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    return sum_over_ranks(topk_counts(logits, labels, valid, topk))[:-1]


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's t [n, ...] (the same shape on each) of `group` (None:
    the default group) concatenated in rank order along the leading axis,
    on t's device."""
    n = _group_size(group)
    if n == 1:
        return t
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(t.device)


def make_sharded_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig, mesh: Mesh, *,
                        tokens=None, n_classes: Optional[int] = None):
    """The batched step over the mesh: f(params, text_cls, adapters0,
    views [S_local, V, 3, H, W], plpd_perm=None) -> AdaptResult. `params`
    are this rank's (`shard_params`); each rank passes its data index's
    rows (`shard_batch`) and runs `make_batched_ttl_fn` on them, over its
    model group's heads on a model axis, where `n_classes` divisible by the
    axis also splits the classifier's classes (JAX's rule); every tensor of
    the result is gathered over the data axis, so each rank holds the whole
    batch's, data index 0's rows first."""
    batched = make_batched_ttl_fn(clip_cfg, cfg, tokens=tokens, mesh=mesh,
                                  n_classes=n_classes)

    def gather(t):
        return all_gather_rows(t, mesh.data_group)

    def step(params, text_cls, adapters0, views,
             plpd_perm=None) -> AdaptResult:
        res = batched(params, text_cls, adapters0, views, plpd_perm)
        return AdaptResult(*(None if f is None else tree_map(gather, f)
                             for f in res))

    return step
