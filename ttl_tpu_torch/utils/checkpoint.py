"""Prompt checkpoint loading (CoOp / CoCoOp), `--load`.

Counterpart of `ttl_tpu/utils/checkpoint.py` (the reference's
load_model_weight, utils/tools.py:105-135): reads a torch checkpoint with a
'state_dict' entry (or a bare state dict), drops the fixed
token_prefix/token_suffix buffers (they are rebuilt from the current class
names) and overlays the remaining tensors onto the prompt states. Tensors
land on the state's device in f32. Base CLIP weights are not read here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch


def load_prompt_state_dict(load_path: str) -> Optional[Dict[str, torch.Tensor]]:
    """Read {name: f32 CPU tensor} from a CoOp/CoCoOp checkpoint; None if
    the file is missing. The file is read with `weights_only=True`: tensors
    and plain containers, no arbitrary pickled objects."""
    if not os.path.isfile(load_path):
        print(f"=> no checkpoint found at '{load_path}'")
        return None
    print(f"=> loading checkpoint '{load_path}'")
    ckpt = torch.load(load_path, map_location="cpu", weights_only=True)
    sd = dict(ckpt.get("state_dict", ckpt))
    for k in ("token_prefix", "token_suffix"):  # rebuilt per dataset
        sd.pop(k, None)
    epoch = ckpt.get("epoch", "?")
    print(f"=> loaded checkpoint '{load_path}' (epoch {epoch})")
    return {k: torch.as_tensor(v).detach().to(torch.float32)
            for k, v in sd.items()}


def _find(sd: dict, suffix: str) -> Optional[str]:
    return next((k for k in sd if k.endswith(suffix)), None)


def apply_prompt_ckpt(pl_state, sd: dict):
    """Overlay a CoOp checkpoint onto a PromptLearnerState: the tunable ctx
    and its reset snapshot come from the checkpoint."""
    key = _find(sd, "ctx")
    if key is None:
        return pl_state
    ctx = sd[key].to(device=pl_state.ctx.device, dtype=torch.float32)
    return dataclasses.replace(pl_state, ctx=ctx, ctx_init=ctx)


def apply_cocoop_ckpt(state, sd: dict):
    """Overlay a CoCoOp checkpoint (ctx + meta_net.linear1/linear2) onto a
    CoCoOpState; the weights transpose to the [in, out] convention."""
    def get(suffix, transpose=False):
        t = sd[_find(sd, suffix)].to(device=state.ctx.device,
                                     dtype=torch.float32)
        return t.T.contiguous() if transpose else t

    updates = {}
    if _find(sd, "ctx"):
        updates["ctx"] = get("ctx")
    if _find(sd, "meta_net.linear1.weight"):
        updates["meta_w1"] = get("meta_net.linear1.weight", transpose=True)
        updates["meta_b1"] = get("meta_net.linear1.bias")
        updates["meta_w2"] = get("meta_net.linear2.weight", transpose=True)
        updates["meta_b2"] = get("meta_net.linear2.bias")
    return dataclasses.replace(state, **updates)
