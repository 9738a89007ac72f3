"""Top-k counts, and data-parallel evaluation over processes.

Counterpart of `ttl_tpu/parallel/eval.py`. Each rank (one process, one
card; `parallel/mesh.py`) runs the single-card batched step over its own
rows of the sample batch. The only traffic between ranks is on the host:
the three counts a batch summed over ranks, and, in `make_sharded_ttl_fn`,
the logits gathered so that every rank holds the whole batch's. The device
program has no collective, as in the JAX design.

The collectives go over the default process group on CPU tensors, and the
runner's launcher initializes it with the gloo backend: NCCL refuses two
ranks on one card, and one card is what shows the data axis end to end
where only one is attached. Moving the reduce onto NCCL belongs with a
machine of several cards.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..adapt.ttl import AdaptResult, make_batched_ttl_fn
from ..config import TTLConfig
from ..models.clip import CLIPConfig, tree_map
from .mesh import NOT_PORTED_MODEL_AXIS, Mesh, _has_model_axis, world_and_rank


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


def sum_over_ranks(counts: torch.Tensor) -> torch.Tensor:
    """int counts summed over every rank of the default group, on the CPU
    (waits for the device); the counts themselves, where they are, when
    there is one process."""
    if world_and_rank()[0] == 1:
        return counts
    total = counts.cpu().to(torch.int64)
    dist.all_reduce(total)
    return total.to(counts.dtype)


def make_count_fn(mesh: Optional[Mesh] = None, topk=(1, 5)):
    """(logits [S, C], labels [S], valid [S]) -> int32 [len(topk)+1]:
    per-k correct counts over the valid rows plus the valid count. With a
    mesh of more than one process, each rank passes its own rows and gets
    the sums over every rank, on the CPU."""
    def counts(logits, labels, valid):
        c = topk_counts(logits, labels, valid, topk)
        return c if mesh is None else sum_over_ranks(c)
    return counts


def sharded_topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                         topk=(1, 5)) -> torch.Tensor:
    """This rank's rows of [S, C] logits and [S] labels -> the correct
    counts per k summed over every rank (int32 [len(topk)]; on the CPU
    when there are several ranks)."""
    valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    return sum_over_ranks(topk_counts(logits, labels, valid, topk))[:-1]


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's t [n, ...] (the same shape on each) concatenated in rank
    order along the leading axis, on t's device."""
    world = world_and_rank()[0]
    if world == 1:
        return t
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(t.device)


def make_sharded_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig, mesh: Mesh, *,
                        tokens=None, n_classes: Optional[int] = None):
    """The batched step over the data axis: f(params, text_cls, adapters0,
    views [S_local, V, 3, H, W], plpd_perm=None) -> AdaptResult. Each rank
    passes its rows (`shard_batch`) and runs `make_batched_ttl_fn` on them;
    every tensor of the result is gathered, so each rank holds the whole
    batch's, rank 0's rows first. `n_classes` would shard the classifier's
    class axis over a model axis, which is not ported (item 21)."""
    if _has_model_axis(mesh):
        raise NotImplementedError(NOT_PORTED_MODEL_AXIS)
    del n_classes
    batched = make_batched_ttl_fn(clip_cfg, cfg, tokens=tokens)

    def step(params, text_cls, adapters0, views,
             plpd_perm=None) -> AdaptResult:
        res = batched(params, text_cls, adapters0, views, plpd_perm)
        return AdaptResult(*(None if f is None else tree_map(all_gather_rows,
                                                             f)
                             for f in res))

    return step
