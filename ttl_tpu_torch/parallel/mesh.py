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
`cuda:{LOCAL_RANK}`. Ranks lie as JAX reshapes its devices into
(data, model): rank r is at data index r // m and model index r % m, so a
model group is m consecutive ranks. Every rank builds the whole parameter
tree from the same seed or file; `replicate` checks that they agree, and on
a model axis `shard_params` keeps the rank's slice by `param_spec`
(`parallel/tensor.py` runs the collectives the slices need).

Collective backends, by one rule: a model group whose ranks drive distinct
cards runs NCCL; one whose ranks share a card (NCCL refuses it: the one-card
smoke) or run on the CPU runs gloo, CUDA tensors staged through the host.
The data groups carry the counts and logits on host tensors over gloo.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .tensor import ModelGroup

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis sizes, this process's rank in the world of processes, the
    device it drives, and on a model axis its data group (the ranks of its
    model index; None: the whole world) and its model group."""
    shape: Dict[str, int]
    rank: int
    world: int
    device: torch.device
    data_group: Any = None
    model: Optional[ModelGroup] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape.get(MODEL_AXIS, 1)


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
    device = torch.device(device)
    axes = dict(zip((DATA_AXIS, MODEL_AXIS), shape))
    m = axes.get(MODEL_AXIS, 1)
    if m == 1:
        return Mesh(axes, rank, world, device)
    data_group, model = _groups(axes[DATA_AXIS], m, rank, device)
    return Mesh(axes, rank, world, device, data_group, model)


def _groups(d: int, m: int, rank: int, device: torch.device):
    """(this rank's data group, its ModelGroup). Every rank creates every
    group, in the same order, as `new_group` requires; a model group runs
    NCCL where its ranks drive distinct cards, else gloo."""
    where = [None] * (d * m)
    dist.all_gather_object(where, (socket.gethostname(), device.type,
                                   device.index))
    model_ranks = [list(range(i * m, (i + 1) * m)) for i in range(d)]
    backends = ["nccl" if all(where[r][1] == "cuda" for r in ranks)
                and len({where[r] for r in ranks}) == m else "gloo"
                for ranks in model_ranks]
    if rank == 0:
        shared = "" if backends[0] == "nccl" else (
            " (ranks share a card or run on the CPU: NCCL refuses a card "
            "shared by ranks)")
        print(f"model axis: {d} group(s) of {m} ranks {model_ranks}, "
              f"collectives over {'/'.join(sorted(set(backends)))}{shared}",
              flush=True)
    model = None
    for ranks, backend in zip(model_ranks, backends):
        group = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            model = ModelGroup(group, m, rank % m, backend)
    data_group = None
    for j in range(m):
        group = dist.new_group(list(range(j, d * m, m)), backend="gloo")
        if rank % m == j:
            data_group = group
    return data_group, model


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
    """The parameter tree on this rank: on a model axis of size m, each
    leaf that `param_spec` splits keeps the rank's m-th part of that axis
    (model index r % m), a contiguous copy; every other leaf stays whole.
    A fused `qkv` projection ([..., 3D] columns: q, k and v side by side)
    keeps the rank's part of each of q, k and v, so that its heads stay
    together. Without a model axis, the tree as it is. Call `replicate`
    first: it checks that every rank holds the same whole tree."""
    if not _has_model_axis(mesh):
        return params
    m = mesh.shape[MODEL_AXIS]
    j = mesh.rank % m

    def part(t: torch.Tensor, dim: int, path: str) -> torch.Tensor:
        n = t.shape[dim]
        if n % m:
            raise ValueError(f"{path}: axis {dim} of {tuple(t.shape)} does "
                             f"not split over a model axis of {m}")
        return t.narrow(dim, j * (n // m), n // m)

    def place(path: str, t: torch.Tensor) -> torch.Tensor:
        spec = param_spec(path, mesh)
        if MODEL_AXIS not in spec:
            return t
        dim = spec.index(MODEL_AXIS)
        if path.split("/")[-2] == "qkv":
            thirds = t.chunk(3, dim=dim)
            if thirds[0].shape[dim] * 3 != t.shape[dim]:
                raise ValueError(f"{path}: {tuple(t.shape)} is not three "
                                 "equal q, k, v blocks")
            return torch.cat([part(b, dim, path) for b in thirds], dim=dim)
        return part(t, dim, path).contiguous()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return place(path, node) if torch.is_tensor(node) else node

    return walk(params, "")


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
    data-axis sharding splits it: contiguous blocks in data-index order;
    the ranks of a model group take the same rows."""
    n_data = mesh.shape[DATA_AXIS]
    index = mesh.data_index

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
