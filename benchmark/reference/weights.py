"""The seeded random weights of the served model, and the fresh adapters.

The benchmark runs the program with random weights drawn from the run's
seed by the program's own initializer. The reference draws them again
here: a frozen copy of that draw order (one host `torch.Generator` seeded
with the run's seed; every stacked leaf drawn in one call, vision tower
first, then text tower), rounded to the type the configuration serves in
and widened back to float32. Layernorm leaves and the logit scale stay
float32, as served. The adapters are the configuration's LoRA init: A with
Xavier-normal draws from a second generator on the same seed (q's, then
v's), B zero.

Layout: every linear holds `w` as [in, out]; transformer layers are
stacked on a leading axis.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _ln(shape):
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def _linear(gen, n, d_in, d_out):
    return {"w": _normal(gen, (n, d_in, d_out), 0.02),
            "b": torch.zeros(n, d_out)}


def _layers(gen, n, d, d_mlp):
    return {"ln1": _ln((n, d)), "ln2": _ln((n, d)),
            "attn": {name: _linear(gen, n, d, d) for name in "qkvo"},
            "mlp": {"fc1": _linear(gen, n, d, d_mlp),
                    "fc2": _linear(gen, n, d_mlp, d)}}


def _served(tree, dtype, in_ln=False):
    """Round every leaf but the layernorms' to the served type, then widen
    to float32 for the reference's arithmetic."""
    if isinstance(tree, dict):
        return {k: _served(v, dtype, in_ln or k.startswith("ln"))
                for k, v in tree.items()}
    return tree if in_ln else tree.to(dtype).float()


def draw_weights(config: dict, seed: int) -> dict:
    """The float32 weights the program serves for `seed` under `config`
    (a configuration file of the benchmark), on the host."""
    v, t = config["vision"], config["text"]
    p = config["projection_dim"]
    gen = torch.Generator().manual_seed(seed)
    grid = v["image_size"] // v["patch_size"]
    d = v["hidden_size"]
    vision = {
        "patch_embed": _normal(gen, (3 * v["patch_size"] ** 2, d), 0.02),
        "class_embed": _normal(gen, (d,), 0.02),
        "pos_embed": _normal(gen, (grid * grid + 1, d), 0.02),
        "ln_pre": _ln(d),
        "layers": _layers(gen, v["num_hidden_layers"], d,
                          v["intermediate_size"]),
        "ln_post": _ln(d),
        "proj": _normal(gen, (d, p), 0.02),
    }
    dt = t["hidden_size"]
    text = {
        "token_embed": _normal(gen, (t["vocab_size"], dt), 0.02),
        "pos_embed": _normal(gen, (t["max_position_embeddings"], dt), 0.01),
        "layers": _layers(gen, t["num_hidden_layers"], dt,
                          t["intermediate_size"]),
        "ln_final": _ln(dt),
        "proj": _normal(gen, (dt, p), 0.02),
    }
    dtype = DTYPES[config["ttl"]["param_dtype"]]
    return {"vision": _served(vision, dtype), "text": _served(text, dtype),
            "logit_scale": torch.tensor(config["logit_scale_init"],
                                        dtype=torch.float32)}


def draw_adapters(config: dict, seed: int) -> dict:
    """Fresh LoRA adapters of the configuration's window: A [L, D, r]
    Xavier-normal, B [L, r, D] zero, for q and v."""
    ttl = config["ttl"]
    lo, hi = ttl["lora_layers"]
    d, r = config["vision"]["hidden_size"], ttl["lora_rank"]
    if ttl["lora_init"] != "xavier":
        raise ValueError(f"lora_init {ttl['lora_init']!r}: the reference "
                         "draws xavier only")
    gen = torch.Generator().manual_seed(seed)
    shape = (hi - lo + 1, d, r)
    std = math.sqrt(2.0 / (d + r))
    a_q = torch.randn(shape, generator=gen) * std
    a_v = torch.randn(shape, generator=gen) * std
    zero = torch.zeros(hi - lo + 1, r, d)
    return {"q": {"A": a_q, "B": zero}, "v": {"A": a_v, "B": zero.clone()}}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
