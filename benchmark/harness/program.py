"""The program's settings for a cell: the configuration and the traffic mix
turned into the port's `TTLConfig`, as a user's command line would set
them."""
from __future__ import annotations

from .manifest import BENCH, load_json


def program_config(cell, seed: int, control=None):
    """`control` "int8" switches on the program's int8 frozen prefix, its
    own lower-precision path."""
    from ttl_tpu_torch.config import TTLConfig

    ttl, traffic = cell.config["ttl"], cell.traffic
    prefix = ttl["prompt_template"].rsplit(" {}", 1)[0]
    return TTLConfig(
        arch=cell.config["program_arch"], seed=seed,
        resolution=cell.config["vision"]["image_size"],
        batch_size=ttl["views"], lr=ttl["lr"], rank=ttl["lora_rank"],
        lora_alpha=ttl["lora_alpha"], init_method=ttl["lora_init"],
        deyo_margin_e0=ttl["deyo_margin_e0"],
        ctx_init=prefix.replace(" ", "_"),
        sample_batch=ttl["sample_batch"], tta_steps=ttl["steps"],
        compute_dtype=ttl["compute_dtype"], param_dtype=ttl["param_dtype"],
        canvas=traffic["canvas"],
        prefix_quant="int8" if control == "int8" else "none")


def classnames(traffic: dict):
    return load_json(BENCH / "data" / traffic["classes"])
