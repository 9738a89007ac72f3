"""CoOp split-JSON datasets and the FGVC-Aircraft txt parser.

Equivalent of the reference's BaseJsonDataset / Aircraft
(data/fewshot_datasets.py:13-48,74-116). Split files are the bundled CoOp
metadata, re-compressed under ttl_tpu_torch/data/assets/splits/. Few-shot
subsampling reproduces the reference's `random.seed(0); random.sample`
per-class draw exactly (fewshot_datasets.py:28-36).
"""
from __future__ import annotations

import gzip
import json
import os
import random
from pathlib import Path
from typing import List, Optional, Tuple

_SPLITS_DIR = Path(__file__).resolve().parent / "assets" / "splits"

SPLIT_FILES = {
    "flower102": "split_zhou_OxfordFlowers.json.gz",
    "food101": "split_zhou_Food101.json.gz",
    "dtd": "split_zhou_DescribableTextures.json.gz",
    "pets": "split_zhou_OxfordPets.json.gz",
    "sun397": "split_zhou_SUN397.json.gz",
    "caltech101": "split_zhou_Caltech101.json.gz",
    "ucf101": "split_zhou_UCF101.json.gz",
    "cars": "split_zhou_StanfordCars.json.gz",
    "eurosat": "split_zhou_EuroSAT.json.gz",
}


def _subsample_n_shot(images: List[str], labels: List[int], n_shot: int):
    """Per-class n-shot draw with the reference's fixed seed
    (fewshot_datasets.py:28-36)."""
    few: List[int] = []
    for c in range(max(labels) + 1):
        c_idx = [i for i, l in enumerate(labels) if l == c]
        random.seed(0)
        few.extend(random.sample(c_idx, n_shot))
    return [images[i] for i in few], [labels[i] for i in few]


class JsonSplitDataset:
    def __init__(self, image_root: str, split_file: str, mode: str = "test",
                 n_shot: Optional[int] = None):
        self.image_root = image_root
        path = _SPLITS_DIR / split_file
        plain = None
        if not path.exists():
            # Food101/SUN397 splits are not bundled (absent from the
            # reference release as well - .MISSING_LARGE_BLOBS): accept the
            # CoOp split JSON dropped next to the dataset images instead.
            plain = Path(image_root) / split_file.replace(".gz", "")
            if not plain.exists():
                raise FileNotFoundError(
                    f"split {split_file} is not bundled; download CoOp's "
                    f"split_zhou_*.json (github.com/KaiyangZhou/CoOp DATASETS"
                    f".md) and place it at {plain}")
        if plain is not None:
            splits = json.loads(plain.read_text())
        else:
            with gzip.open(path, "rt", encoding="utf-8") as f:
                splits = json.load(f)
        samples = splits[mode]
        self.image_list = [s[0] for s in samples]
        self.label_list = [int(s[1]) for s in samples]
        if n_shot is not None:
            self.image_list, self.label_list = _subsample_n_shot(
                self.image_list, self.label_list, n_shot)

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, idx) -> Tuple[str, int]:
        return (os.path.join(self.image_root, self.image_list[idx]),
                self.label_list[idx])


class AircraftDataset:
    """FGVC variant-txt parser (fewshot_datasets.py:74-116)."""

    def __init__(self, root: str, mode: str = "test",
                 n_shot: Optional[int] = None):
        self.root = root
        with open(os.path.join(root, "variants.txt")) as f:
            self.classnames = [l.rstrip("\n") for l in f]
        self.image_list: List[str] = []
        self.label_list: List[int] = []
        with open(os.path.join(root, f"images_variant_{mode}.txt")) as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                self.image_list.append(f"{parts[0]}.jpg")
                self.label_list.append(
                    self.classnames.index(" ".join(parts[1:])))
        if n_shot is not None:
            self.image_list, self.label_list = _subsample_n_shot(
                self.image_list, self.label_list, n_shot)

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, idx) -> Tuple[str, int]:
        return (os.path.join(self.root, "images", self.image_list[idx]),
                self.label_list[idx])
