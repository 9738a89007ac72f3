"""The comparison that decides `correct`.

The program's answers are its printed ones: each image's top-k labels with
their probabilities (after adaptation) and its zero-shot label. The
reference recomputes the same image's logits in float32. The numbers,
over the answers checked (each cell's file says which it compares, and
with what limit):

- `adapted_logprob_gap`: over an answer's top-k entries, |ln p - ln p_ref|
  of the label's probability, p as the program printed it, p_ref from the
  reference's adapted logits;
- `adapted_logprob_mean_gap`: the mean of the same over every top-k entry
  of every answer checked, steadier from seed to seed than the widest;
- `adapted_top1_gap`: how far the reference's adapted logit of the
  program's top-1 label lies below the reference's best;
- `zero_shot_gap`: the same for the zero-shot label, against the
  reference's zero-shot logits.

A label that names two classes (ImageNet's 1000-class table repeats two
names) is judged by whichever of its classes is closer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

PROB_FLOOR = 5e-7    # the predict lines round probabilities to 6 digits


def label_index(classnames: Sequence[str]) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {}
    for i, name in enumerate(classnames):
        out.setdefault(name, []).append(i)
    return out


def numbers(answers: List[dict], reference: Dict, classnames) -> dict:
    """answers: dicts with `key`, `topk` [(label, prob)], `zero_shot_label`;
    reference: key -> (adapted logits [C], zero-shot logits [C]) as lists
    or tensors."""
    index = label_index(classnames)
    logprob, top1, zs = 0.0, 0.0, 0.0
    gaps = []
    for ans in answers:
        adapted, zero_shot = reference[ans["key"]]
        adapted = [float(x) for x in adapted]
        zero_shot = [float(x) for x in zero_shot]
        mx = max(adapted)
        lse = mx + math.log(sum(math.exp(x - mx) for x in adapted))
        for label, prob in ans["topk"]:
            gap = min(abs(math.log(max(prob, PROB_FLOOR)) - (adapted[i] - lse))
                      for i in index[label])
            logprob = max(logprob, gap)
            gaps.append(gap)
        label = ans["topk"][0][0]
        top1 = max(top1, mx - max(adapted[i] for i in index[label]))
        zmx = max(zero_shot)
        zs = max(zs, zmx - max(zero_shot[i]
                               for i in index[ans["zero_shot_label"]]))
    return {"adapted_logprob_gap": logprob,
            "adapted_logprob_mean_gap": sum(gaps) / max(len(gaps), 1),
            "adapted_top1_gap": top1, "zero_shot_gap": zs}


def decide(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number with a limit must be at or under
    it. checks maps each number to its value and limit (None: printed, not
    compared: a number whose control reading does not separate from the
    sound ones, PERF.md)."""
    checks, correct = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            correct = False
    return correct, checks
