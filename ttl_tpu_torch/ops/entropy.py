"""Entropy objectives over logits, in float32.

Counterpart of `softmax_entropy`, `avg_entropy`, `select_confident`,
`tpt_loss` and `deyo_loss` in `ttl_tpu/ops/entropy.py`, over any leading
batch axes: logits [..., N, C] give per-batch losses [...].
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


def avg_entropy(logits: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Entropy of the averaged predictive distribution H(mean_i p_i) over
    the N rows of each batch entry, in the log domain and clamped at the f32
    minimum: logits [..., N, C] -> [...]. With `mask` [..., N] the average
    runs over the rows where it is set."""
    logits = logits.float()
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    if mask is None:
        avg_logp = torch.logsumexp(logp, dim=-2) - math.log(logits.shape[-2])
    else:
        masked = torch.where(mask.unsqueeze(-1), logp,
                             torch.full_like(logp, -math.inf))
        avg_logp = torch.logsumexp(masked, dim=-2) - torch.log(
            mask.float().sum(dim=-1, keepdim=True))
    avg_logp = avg_logp.clamp(min=torch.finfo(avg_logp.dtype).min)
    return -(avg_logp * avg_logp.exp()).sum(dim=-1)


def select_confident(logits: torch.Tensor, k: int):
    """The k lowest-entropy rows of each batch entry: logits [..., N, C] ->
    (selected logits [..., k, C], idx [..., k], mask [..., N] bool). Equal
    entropies break towards the lower index, as `jax.lax.top_k` on the
    negated entropies does."""
    ent = softmax_entropy(logits)
    idx = torch.argsort(ent, dim=-1, stable=True)[..., :k]
    mask = torch.zeros_like(ent, dtype=torch.bool).scatter(-1, idx, True)
    picked = torch.gather(
        logits, -2, idx.unsqueeze(-1).expand(*idx.shape, logits.shape[-1]))
    return picked, idx, mask


def tpt_loss(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """TPT objective: the entropy of the distribution averaged over the
    selected rows."""
    return avg_entropy(logits, mask=mask)
