"""Entropy objectives over logits, in float32.

Counterpart of `softmax_entropy` and `deyo_loss` in `ttl_tpu/ops/entropy.py`,
over any leading batch axes: logits [..., N, C] give per-batch losses [...].
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LOG1000 = math.log(1000.0)


def softmax_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-row Shannon entropy of softmax(logits): [..., C] -> [...]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def deyo_loss(logits: torch.Tensor, *,
              margin_e0: float = 0.4,
              deyo_margin: float = 0.5,
              filter_ent: bool = False,
              selection_p: float = 0.1,
              reweight_ent: float = 1.0,
              plpd: Optional[torch.Tensor] = None,
              filter_plpd: bool = False,
              plpd_threshold: float = 0.2,
              reweight_plpd: float = 0.0):
    """DeYO-weighted entropy over the N views of each batch entry.

      ent_i   = H(softmax(logits_i))
      keep_i  = ent_i <= log(1000)               (filter_ent off, the default)
                or i among the int(N*p) lowest entropies (filter_ent on)
                and, with filter_plpd, plpd_i > plpd_threshold
      coeff_i = reweight_ent * exp(-(stop_grad(ent_i) - margin_e0)) when
                reweight_ent or reweight_plpd is set, else 1
      loss    = mean over kept views of ent_i * coeff_i, 0 if none is kept

    deyo_margin is unused, as in the reference. Returns (loss [...], aux)
    with aux["n_backward"] the kept count [...]: callers skip the update
    where it is 0."""
    n = logits.shape[-2]
    ent = softmax_entropy(logits)
    if filter_ent:
        k = int(n * selection_p)
        keep = torch.zeros_like(ent, dtype=torch.bool)
        if k > 0:
            idx = torch.topk(-ent, k, dim=-1).indices
            keep = keep.scatter(-1, idx, True)
    else:
        keep = ent <= LOG1000
    if plpd is not None and filter_plpd:
        keep = keep & (plpd > plpd_threshold)
    if reweight_ent or reweight_plpd:
        coeff = reweight_ent * torch.exp(-(ent.detach() - margin_e0))
    else:
        coeff = torch.ones_like(ent)
    keep_f = keep.float()
    n_backward = keep_f.sum(dim=-1)
    loss = (ent * coeff * keep_f).sum(dim=-1) / n_backward.clamp(min=1.0)
    loss = torch.where(n_backward > 0, loss, torch.zeros_like(loss))
    return loss, {"ent": ent, "coeff": coeff, "keep": keep,
                  "n_backward": n_backward}
