"""Bongard-HOI episodic dataset.

Equivalent of the reference's BongardDataset (data/hoi_dataset.py:26-111):
each task is a few-shot episode of positive/negative human-object-interaction
images (6 support + 1 query per polarity, fixed seed-0 shuffle). The split
JSONs (`bongard_hoi_{mode}_{split}.json`) are external metadata the user
supplies (the reference does not bundle them either); images resolve against
`data_root`, with the reference's val<->train pic-path fallback.

Episodes are returned as path lists; decoding/augmentation goes through the
standard host-canvas pipeline (ttl_tpu_torch.data.views). The port's own
copy of `ttl_tpu/data/bongard.py`.
"""
from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class BongardEpisode:
    support_paths: List[str]      # 6 pos then 6 neg
    support_labels: List[int]     # [0]*6 + [1]*6 (reference convention)
    query_paths: List[str]        # [neg_query, pos_query]
    query_labels: List[int]       # [1, 0]
    annotation: Optional[str] = None


class BongardDataset:
    def __init__(self, data_root: str, data_split: str = "unseen_obj_unseen_act",
                 mode: str = "test", with_annotation: bool = False,
                 splits_dir: str = "data/bongard_splits"):
        assert mode in ("val", "test")
        self.data_root = data_root
        self.with_annotation = with_annotation
        data_file = os.path.join(
            splits_dir, f"bongard_hoi_{mode}_{data_split}.json")
        with open(data_file) as fp:
            task_items = json.load(fp)
        self.tasks = []
        for task in task_items:
            self.tasks.append({
                "neg": [s["im_path"] for s in task[0]],
                "pos": [s["im_path"] for s in task[1]],
                "annotation": str(task[-1]).replace("++", " "),
            })

    def __len__(self):
        return len(self.tasks)

    def _resolve(self, path: str) -> str:
        p = os.path.join(self.data_root, path.replace("./", ""))
        if not os.path.isfile(p):  # reference's pic val<->train fallback
            if "/pic/image/val" in p:
                p = p.replace("val", "train")
            elif "/pic/image/train" in p:
                p = p.replace("train", "val")
        return p

    def __getitem__(self, idx: int) -> BongardEpisode:
        task = self.tasks[idx]
        pos = list(task["pos"])
        neg = list(task["neg"])
        random.seed(0)  # reference: fixed shuffle per episode
        random.shuffle(pos)
        random.shuffle(neg)
        return BongardEpisode(
            support_paths=[self._resolve(p) for p in pos[:-1] + neg[:-1]],
            support_labels=[0] * len(pos[:-1]) + [1] * len(neg[:-1]),
            query_paths=[self._resolve(neg[-1]), self._resolve(pos[-1])],
            query_labels=[1, 0],
            annotation=task["annotation"] if self.with_annotation else None,
        )
