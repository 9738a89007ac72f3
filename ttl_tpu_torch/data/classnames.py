"""Classname tables and OOD label-mask resolution.

Data comes from the JSON assets extracted from the public tables the
reference bundles (data/imagnet_prompts.py, data/cls_to_names.py,
data/imagenet_variants.py). `resolve_classnames` reproduces the reference's
per-set_id mask logic exactly, including its asymmetries
(ttl.py:255-271):

- 'R' iterates a boolean mask over ascending class index;
- 'A' indexes with the 200-entry index list;
- 'V' reorders all 1000 classes into ImageNetV2's string-sorted directory
  order ("0","1","10",...,"999") so labels from the lexicographic folder
  walk line up with the classifier rows;
- fewshot set_ids use their own tables; 'I'/'K' use the full 1000.
"""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import List

_ASSETS = Path(__file__).resolve().parent / "assets"


@lru_cache()
def imagenet_classnames() -> tuple:
    return tuple(json.loads((_ASSETS / "imagenet_classnames.json").read_text()))


@lru_cache()
def dataset_classnames() -> dict:
    return json.loads((_ASSETS / "dataset_classnames.json").read_text())


@lru_cache()
def variant_masks() -> dict:
    return json.loads((_ASSETS / "imagenet_variant_masks.json").read_text())


@lru_cache()
def cifar10_classnames() -> tuple:
    return tuple(json.loads((_ASSETS / "cifar10_classnames.json").read_text()))


def resolve_classnames(set_id: str) -> List[str]:
    if len(set_id) > 1:  # fewshot ids (ttl.py:255-256)
        key = set_id.lower()
        if key == "cifar10":
            return list(cifar10_classnames())
        tables = dataset_classnames()
        if key not in tables:
            raise KeyError(f"no classname table for {set_id!r}")
        return list(tables[key])
    assert set_id in ("A", "R", "K", "V", "I")
    all_names = list(imagenet_classnames())
    masks = variant_masks()
    if set_id == "A":
        return [all_names[i] for i in masks["imagenet_a_indices"]]
    if set_id == "R":
        return [all_names[i] for i in masks["imagenet_r_indices"]]
    if set_id == "V":
        return [all_names[i] for i in masks["imagenet_v_indices"]]
    return all_names  # I, K
