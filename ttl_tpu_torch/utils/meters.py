"""Metrics and progress meters.

Same observable surface as the reference's utils/tools.py:14-102
(AverageMeter / ProgressMeter / Summary / accuracy) so run logs are
comparable line-for-line; accuracy works on numpy arrays.
"""
from __future__ import annotations

from enum import Enum

import numpy as np


class Summary(Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    """Tracks current value, average, sum, count (tools.py:20-63)."""

    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
                ).format(**self.__dict__)

    def summary(self):
        if self.summary_type is Summary.NONE:
            return ""
        if self.summary_type is Summary.AVERAGE:
            return "{name} {avg:.3f}".format(**self.__dict__)
        if self.summary_type is Summary.SUM:
            return "{name} {sum:.3f}".format(**self.__dict__)
        return "{name} {count:.3f}".format(**self.__dict__)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        fmt = "{:" + str(len(str(num_batches))) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)

    def display_summary(self):
        entries = [" *"] + [m.summary() for m in self.meters if m.summary()]
        print(" ".join(entries), flush=True)


def accuracy(output, target, topk=(1,)):
    """Top-k accuracy in percent (tools.py:88-102). output [B, C] logits,
    target [B] int labels."""
    output = np.asarray(output)
    target = np.asarray(target).reshape(-1)
    maxk = max(topk)
    pred = np.argsort(-output, axis=-1)[:, :maxk]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]
