"""ImageFolder-style directory walker.

Self-contained replacement for torchvision's ImageFolder / the reference's
FilteredImageNetDataset (data/filtered_dataset.py:49-110,284-387): classes
are the sorted child directories, samples the sorted image files beneath
each, with an optional per-class cap (`images_per_class`, ttl.py:401).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


class ImageFolderDataset:
    def __init__(self, root: str, images_per_class: Optional[int] = None):
        self.root = root
        self.classes = sorted(
            d.name for d in os.scandir(root) if d.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            cdir = os.path.join(root, cls)
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(cdir) for f in fs
                if f.lower().endswith(IMG_EXTENSIONS))
            if images_per_class is not None:
                files = files[:images_per_class]
            self.samples.extend((f, self.class_to_idx[cls]) for f in files)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Tuple[str, int]:
        return self.samples[idx]
