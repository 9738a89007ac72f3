"""Dataset registry and construction.

Same set_id surface as the reference (data/datautils.py:20-73): ImageNet 'I',
OOD variants 'A'/'K'/'R'/'V', the ten CoOp cross-datasets, and 'bongard'.
Datasets here are lightweight *sample lists* (path, label) - decoding and
augmentation live in `data/views.py` (host decode -> device views), not in
worker processes. The port's own copy of `ttl_tpu/data/registry.py`.
"""
from __future__ import annotations

import os
from .folder import ImageFolderDataset
from .json_splits import AircraftDataset, JsonSplitDataset, SPLIT_FILES

ID_TO_DIRNAME = {
    "I": "ImageNet",
    "A": "imagenet-adversarial/imagenet-a",
    "K": "ImageNet-Sketch",
    "R": "imagenet-rendition/imagenet-r",
    "V": "imagenetv2/imagenetv2-matched-frequency-format-val",
    "flower102": "oxford_flowers",
    "dtd": "dtd",
    "pets": "oxford_pets/images",
    "cars": "stanford_cars",
    "ucf101": "ucf101/UCF-101-midframes",
    "caltech101": "caltech-101/101_ObjectCategories",
    "food101": "food-101",
    "sun397": "sun397/SUN397",
    "aircraft": "fgvc_aircraft",
    "eurosat": "eurosat/2750",
}

FEWSHOT_DATASETS = ["DTD", "flower102", "Food101", "Cars", "SUN397",
                    "Aircraft", "Pets", "Caltech101", "UCF101", "eurosat"]

# image subdirectory inside each dataset root (fewshot_datasets.py:53-64)
_IMAGE_SUBDIR = {
    "flower102": "jpg",
    "food101": "images",
    "dtd": "images",
}


_CIFAR10_DIR = "cifar-10-batches-py"
_IMAGENET_SPLIT = "val"


def build_dataset(set_id: str, args, n_shot=None):
    """Resolve a set_id to a (path, label) sample list dataset
    (datautils.py:38-73). `args` needs .data, .dataset_mode,
    .images_per_class."""
    root = args.data
    if set_id == "I":
        return ImageFolderDataset(
            os.path.join(root, ID_TO_DIRNAME["I"], _IMAGENET_SPLIT))
    if set_id in ("A", "K", "R", "V"):
        return ImageFolderDataset(
            os.path.join(root, ID_TO_DIRNAME[set_id]),
            images_per_class=getattr(args, "images_per_class", None))
    if set_id in FEWSHOT_DATASETS:
        base = os.path.join(root, ID_TO_DIRNAME[set_id.lower()])
        if set_id.lower() == "aircraft":
            return AircraftDataset(base, mode=args.dataset_mode,
                                   n_shot=n_shot)
        subdir = _IMAGE_SUBDIR.get(set_id.lower(), "")
        ds = JsonSplitDataset(
            os.path.join(base, subdir) if subdir else base,
            SPLIT_FILES[set_id.lower()], mode=args.dataset_mode,
            n_shot=n_shot)
        if set_id.lower() == "eurosat":
            # EuroSAT images are a fixed 64x64 (Sentinel-2 patches) - the
            # declared bound lets the runner auto-fit its host->device
            # canvas (64x less upload than the 512 default; identical
            # results, TTLConfig.canvas)
            ds.max_image_dim = 64
        return ds
    if set_id == "bongard":
        from .bongard import BongardDataset
        return BongardDataset(root, mode=args.dataset_mode)
    if set_id.lower() == "cifar10":
        from .cifar10 import Cifar10Dataset
        return Cifar10Dataset(os.path.join(root, _CIFAR10_DIR),
                              mode=args.dataset_mode)
    raise NotImplementedError(f"unknown set_id {set_id!r}")


def expected_subdir(set_id: str) -> str | None:
    """On-disk directory a set_id resolves to under the data root. Shares
    its literals with build_dataset so the runner's early existence check
    can never drift from what `build_dataset` actually opens."""
    if set_id.lower() == "cifar10":
        return _CIFAR10_DIR
    if set_id == "I":
        return os.path.join(ID_TO_DIRNAME["I"], _IMAGENET_SPLIT)
    return ID_TO_DIRNAME.get(set_id if set_id in ID_TO_DIRNAME
                             else set_id.lower())


def dataset_exists(set_id: str, data_root: str) -> bool:
    sub = expected_subdir(set_id)
    return sub is not None and os.path.isdir(os.path.join(data_root, sub))
