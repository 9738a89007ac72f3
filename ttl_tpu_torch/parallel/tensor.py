"""Tensor parallelism over a model group: the collectives inside the towers'
autograd graph.

The JAX package splits q/k/v and fc1 by output columns and o and fc2 by
input rows over its model axis (`parallel/mesh.py::param_spec`), and GSPMD
inserts the all-reduces. Here each rank of a model group holds its slice
(`parallel/mesh.py::shard_params`) and the towers call three functions:

- `copy_to_model(x)`: the identity forward; the gradient summed over the
  group backward. It stands at the input of every column-split product,
  whose gradient on each rank covers only that rank's columns.
- `reduce_from_model(x)`: x summed over the group forward; the identity
  backward. It follows every row-split product.
- `gather_classes(x)`: each rank's class columns concatenated along the
  last axis forward; backward each rank takes its own columns of the
  gradient. Every rank of the group computes the same loss from the same
  gathered logits, so summing the gradient over the ranks, as
  `torch.distributed.nn.functional.all_gather` does, would scale it by the
  group's size.

Sums run in f32 and come back in the input's dtype: a partial product
reduced in bf16 would round twice where one card rounds once.

Which group the towers use is the one of the step that runs them: a step
built with a mesh runs under `over(mesh.model)`. The towers read it with
`active()` where they meet split weights, also from the autograd engine's
threads, which run the backward and recompute checkpointed layers.
Collectives on CUDA tensors over gloo (ranks that share a card) go through
the host here; over NCCL they stay on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class ModelGroup:
    """One model group of the mesh: the process group, its size, this
    rank's index in it, the backend, and the host seconds and number of
    the collectives it ran (read by the smoke)."""
    group: Any
    size: int
    index: int
    backend: str
    seconds: float = 0.0
    calls: int = 0


_ACTIVE: Optional[ModelGroup] = None


@contextlib.contextmanager
def over(group: Optional[ModelGroup]):
    """Run the towers over `group` (None: no model axis) inside the block."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, group
    try:
        yield
    finally:
        _ACTIVE = previous


def active() -> ModelGroup:
    """The model group of the step that is running; raises where split
    weights meet no step built with a mesh."""
    if _ACTIVE is None:
        raise ValueError("the parameters are split over a model axis "
                         "(parallel.mesh.shard_params), but the step was not "
                         "made with that mesh: pass mesh= to its factory")
    return _ACTIVE


def _staged(t: torch.Tensor, mg: ModelGroup) -> bool:
    return mg.backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The sum of t over the group, in f32, returned in t's dtype (a new
    tensor; t is left as it is)."""
    start = time.perf_counter()
    x = t.to("cpu" if _staged(t, mg) else t.device, torch.float32,
             copy=True)
    dist.all_reduce(x, group=mg.group)
    out = x.to(t.device).to(t.dtype)
    mg.seconds += time.perf_counter() - start
    mg.calls += 1
    return out


def all_gather_last(t: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Every rank's t concatenated along the last axis in rank order."""
    start = time.perf_counter()
    x = t.detach().to("cpu" if _staged(t, mg) else t.device).contiguous()
    parts = [torch.empty_like(x) for _ in range(mg.size)]
    dist.all_gather(parts, x, group=mg.group)
    out = torch.cat(parts, dim=-1).to(t.device)
    mg.seconds += time.perf_counter() - start
    mg.calls += 1
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return all_reduce(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherClasses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg, ctx.n = mg, x.shape[-1]
        return all_gather_last(x, mg)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mg.index * ctx.n
        return grad[..., lo:lo + ctx.n].contiguous(), None


def copy_to_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mg)


def gather_classes(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _GatherClasses.apply(x, mg)
