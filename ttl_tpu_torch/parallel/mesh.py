"""The mesh of processes, and the placement rules of the JAX package.

Counterpart of `ttl_tpu/parallel/mesh.py`. The reference is strictly
single-GPU; the JAX package scales over a device mesh:

- **data axis**: each device adapts different test samples. Episodic adapter
  and optimizer state is per sample by construction, so the step shards over
  samples with no traffic in the hot loop; only the accuracy counts cross
  devices, once a batch.
- **model axis**: megatron-style head/ffn shards of the attention and MLP
  blocks, and a class-axis shard of the text classifier.

Here the mesh is the world of processes, one process per card, as
`torch.distributed` runs them: process `rank` of `world` drives
`cuda:{LOCAL_RANK}`. Only the data axis runs; `param_spec` keeps the JAX
package's rules for the model axis, and `shard_params` on a model axis
larger than 1 raises (ROADMAP Queue 1, item 21). Every rank holds the whole
parameter tree, built from the same seed or file; `replicate` checks that
they agree.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

NOT_PORTED_MODEL_AXIS = (
    "a model axis larger than 1 (--mesh_shape d,m with m > 1) is not ported "
    "to ttl_tpu_torch yet (ROADMAP Queue 1, item 21); the port shards the "
    "data axis only: --mesh_shape N or N,1")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis sizes, this process's rank in the world of processes and
    the device it drives."""
    shape: Dict[str, int]
    rank: int
    world: int
    device: torch.device


def world_and_rank() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) when
    torch.distributed is not initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def check_mesh_shape(shape: Optional[Tuple[int, ...]], world: int) -> None:
    """Raise unless `shape` (None: all processes on the data axis) fits a
    world of `world` processes."""
    if shape is None:
        return
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {tuple(shape)}: expected N (data) or "
                         "N,M (data, model) with positive sizes")
    if math.prod(shape) != world:
        hint = "" if world > 1 else (
            "; a run over N cards starts N processes: python -m "
            "torch.distributed.run --nproc_per_node N -m ttl_tpu_torch "
            "DATA ... --init_distributed")
        raise ValueError(f"mesh shape {tuple(shape)} != {world} "
                         f"process{'es' if world > 1 else ''}{hint}")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              device=None) -> Mesh:
    """The mesh over the world of processes: shape=(data,) or (data, model),
    default every process on the data axis. `device` defaults to the card
    `cuda:{LOCAL_RANK}`; pass "cpu" to run on the CPU."""
    world, rank = world_and_rank()
    shape = (world,) if shape is None else tuple(shape)
    check_mesh_shape(shape, world)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return Mesh(dict(zip((DATA_AXIS, MODEL_AXIS), shape)), rank, world,
                torch.device(device))


def _has_model_axis(mesh: Mesh) -> bool:
    return mesh.shape.get(MODEL_AXIS, 1) > 1


def param_spec(path: str, mesh: Mesh) -> Tuple[Optional[str], ...]:
    """Megatron-style tensor-parallel placement by parameter path, as a
    tuple of axis names per dimension (() replicates), as JAX's
    PartitionSpec reads.

    q/k/v and fc1 split the output feature dim; o and fc2 split the input
    dim (so each pair contracts locally and one all-reduce follows each
    block). Everything else - embeddings, layernorms, and non-transformer
    towers (ResNet conv stacks, attnpool) - replicates. Matching is on exact
    path segments under a stacked 'layers' node, so e.g. the RN50
    'attnpool/q/w' (a 2D array) never picks up the 3D stacked-layer specs.
    """
    if not _has_model_axis(mesh):
        return ()
    parts = tuple(path.split("/"))
    if "layers" not in parts or "prefix_q" in parts:
        # prefix_q (the int8 frozen-prefix copy) replicates: its
        # per-output-channel scales would need a matching split
        return ()

    def ends_with(*suffix):
        return parts[-len(suffix):] == suffix

    if (ends_with("attn", "q", "w") or ends_with("attn", "k", "w")
            or ends_with("attn", "v", "w") or ends_with("attn", "qkv", "w")
            or ends_with("mlp", "fc1", "w")):
        return (None, None, MODEL_AXIS)  # stacked [L, in, out]
    if ends_with("attn", "o", "w") or ends_with("mlp", "fc2", "w"):
        return (None, MODEL_AXIS, None)
    if (ends_with("attn", "q", "b") or ends_with("attn", "k", "b")
            or ends_with("attn", "v", "b") or ends_with("attn", "qkv", "b")
            or ends_with("mlp", "fc1", "b")):
        return (None, MODEL_AXIS)
    return ()


def shard_params(params, mesh: Mesh):
    """The parameter tree on this rank: whole, on the data axis. A model
    axis larger than 1 raises NotImplementedError."""
    if _has_model_axis(mesh):
        raise NotImplementedError(NOT_PORTED_MODEL_AXIS)
    return replicate(params, mesh)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def checksum(tree) -> torch.Tensor:
    """int64 [n_leaves, 2] on the CPU: each tensor leaf's element count and
    the sum of its elements' bit patterns, weighted by position modulo a
    prime, so that a changed or moved bit shows."""
    rows = []
    for t in _leaves(tree):
        bits = t.detach().contiguous().reshape(-1)
        if bits.is_floating_point():
            bits = bits.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                              8: torch.int64}[bits.element_size()])
        bits = bits.to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        rows.append(torch.stack([torch.tensor(bits.numel(),
                                              device=bits.device),
                                 (bits * weight).sum()]).cpu())
    return torch.stack(rows) if rows else torch.zeros(0, 2, dtype=torch.int64)


def replicate(tree, mesh: Mesh):
    """`tree` as it is: every rank built it from the same seed or file.
    With more than one process, rank 0's checksum is broadcast once and a
    rank whose tree differs raises."""
    if mesh.world > 1:
        mine = checksum(tree)
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        if not torch.equal(mine, theirs):
            raise RuntimeError(
                f"rank {mesh.rank}'s parameters differ from rank 0's: every "
                "rank must build them from the same --seed or "
                "--checkpoint_path")
    return tree


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every leaf's leading (sample) axis, as JAX's
    data-axis sharding splits it: contiguous blocks in rank order."""
    n_data = mesh.shape[DATA_AXIS]
    index = mesh.rank // mesh.shape.get(MODEL_AXIS, 1)

    def rows(a):
        if a.shape[0] % n_data:
            raise ValueError(f"leading axis {a.shape[0]} is not a multiple "
                             f"of the data axis ({n_data})")
        n = a.shape[0] // n_data
        return a[index * n:(index + 1) * n]

    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    return rows(tree)
