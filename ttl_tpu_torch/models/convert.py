"""Weight bridge between the JAX package's parameter pytrees and the port.

The JAX package keeps parameters as nested dicts of arrays in the layout the
port uses too ([in, out] linears, layers stacked on axis 0), so the bridge is
one tensor per leaf; a tower whose q, k and v are fused into one `qkv`
projection (`fuse_qkv_params` of either package) bridges the same way. `np.asarray` of a JAX bfloat16 array is an ml_dtypes
array that `torch.from_numpy` refuses; such leaves go through float32 and
back to bfloat16, which is exact.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _prefix_q_from_numpy(tree: Any, device) -> Any:
    """The int8 prefix copy (`ops/quant.py`): `wq` stays int8, every other
    leaf (scales, biases, layernorms) is float32; zero-length stacks stay
    zero-length."""
    if isinstance(tree, dict):
        return {k: _prefix_q_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return tensor_from_numpy(a, device, torch.int8 if a.dtype == np.int8
                             else torch.float32)


def params_from_numpy(tree: Any, device, param_dtype: Optional[torch.dtype]
                      = None) -> Any:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict.

    param_dtype None keeps every leaf's own dtype. Otherwise leaves with two
    or more axes become param_dtype and the rest float32, the rule the JAX
    runner applies to converted checkpoints. The int8 prefix copy under
    `prefix_q` keeps its own types either way."""
    if isinstance(tree, dict):
        return {k: (_prefix_q_from_numpy(v, device) if k == "prefix_q"
                    else params_from_numpy(v, device, param_dtype))
                for k, v in tree.items()}
    a = np.asarray(tree)
    if param_dtype is None:
        return tensor_from_numpy(a, device)
    return tensor_from_numpy(a, device,
                             param_dtype if a.ndim >= 2 else torch.float32)


def adapters_from_numpy(tree: Any, device) -> Any:
    """JAX `adapters0` pytree -> the port's adapters (float32 leaves)."""
    if isinstance(tree, dict):
        return {k: adapters_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device, torch.float32)


def prompt_learner_from_numpy(state: Any, device):
    """The JAX package's `PromptLearnerState` (any object with its fields,
    array leaves readable by numpy) -> the port's dataclass: float leaves
    keep their dtype, the token table and name lengths become int64."""
    from .prompts import PromptLearnerState

    def leaf(name, dtype=None):
        a = getattr(state, name)
        return None if a is None else tensor_from_numpy(a, device, dtype)

    return PromptLearnerState(
        ctx=leaf("ctx"), ctx_init=leaf("ctx_init"), prefix=leaf("prefix"),
        suffix=leaf("suffix"), tokenized=leaf("tokenized", torch.int64),
        name_lens=leaf("name_lens", torch.int64), n_ctx=int(state.n_ctx),
        prompt_prefix=str(state.prompt_prefix),
        ctx_position=str(state.ctx_position), cls=leaf("cls"),
        cls_init=leaf("cls_init"))


def cocoop_state_from_numpy(state: Any, device):
    """The JAX package's `CoCoOpState` (any object with its fields, array
    leaves readable by numpy) -> the port's dataclass, leaf by leaf: float
    leaves keep their dtype, the token table becomes int64."""
    from ..adapt.cocoop import CoCoOpState

    def leaf(name, dtype=None):
        return tensor_from_numpy(getattr(state, name), device, dtype)

    return CoCoOpState(
        ctx=leaf("ctx"), meta_w1=leaf("meta_w1"), meta_b1=leaf("meta_b1"),
        meta_w2=leaf("meta_w2"), meta_b2=leaf("meta_b2"),
        prefix=leaf("prefix"), suffix=leaf("suffix"),
        tokenized=leaf("tokenized", torch.int64), n_ctx=int(state.n_ctx))


def params_to_numpy(tree: Any) -> Any:
    """The port's parameters -> numpy (bfloat16 leaves as float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
