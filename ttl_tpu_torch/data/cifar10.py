"""CIFAR-10 pickle-batch loader.

The reference bundles `data/cifar-10-batches-py/` (batches.meta + readme;
the data batches are stripped upstream, .MISSING_LARGE_BLOBS) but ships NO
loader code for it (SURVEY.md component 22). This loader completes the
capability so the bundled stub becomes a runnable offline smoke config
(BASELINE.json config 1: zero-shot eval on CIFAR-10 batches): it reads the
standard python-version batch pickles (data_batch_1..5 / test_batch, rows of
3072 uint8 = [3,32,32] channel-major) and serves [32,32,3] uint8 arrays
through the normal host-canvas pipeline.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np


class Cifar10Dataset:
    """mode='test' -> test_batch; mode='train' -> data_batch_1..5."""

    max_image_dim = 32  # lets the runner auto-fit the canvas

    def __init__(self, root: str, mode: str = "test"):
        files = (["test_batch"] if mode == "test"
                 else [f"data_batch_{i}" for i in range(1, 6)])
        missing = [n for n in files
                   if not os.path.exists(os.path.join(root, n))]
        if missing:
            # refuse partial archives: a silently truncated split would
            # report accuracy over a subset
            raise FileNotFoundError(
                f"missing CIFAR-10 {mode} batch(es) under {root!r}: "
                f"{', '.join(missing)} - the reference bundles only "
                "batches.meta (data stripped); place the complete "
                "python-version batch files there to run this config")
        images: List[np.ndarray] = []
        labels: List[int] = []
        for name in files:
            with open(os.path.join(root, name), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            data = np.asarray(batch[b"data"], np.uint8)
            images.append(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.extend(batch[b"labels"])
        self.images = np.concatenate(images, axis=0)
        self.labels = np.asarray(labels, np.int64)
        meta = os.path.join(root, "batches.meta")
        self.classnames = None
        if os.path.exists(meta):
            with open(meta, "rb") as f:
                m = pickle.load(f, encoding="bytes")
            self.classnames = [n.decode() for n in m[b"label_names"]]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])
