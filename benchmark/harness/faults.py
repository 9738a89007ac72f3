"""Faults planted underneath the timed path, for the check's own tests:
the check must find each one not correct. Each patches the program in the
calling process (pytest's monkeypatch, or `patch` here for a tool run).

- `unchanged`: the step returns its adapters unchanged (no AdamW update);
- `half`: half of the step's batch left out of the loss, the mean taken
  over the rest (the left-out images go unadapted);
- `altered`: the answer altered where it is produced (the printed
  probabilities shifted by one class);
- `aux_altered`: the zero-shot aux pass's answer altered where it is
  produced (the step's zero-shot logits shifted by one class).

The cells run on one card, so no exchange between chips can be left out.
"""
from __future__ import annotations

import numpy as np
import torch

FAULTS = ("unchanged", "half", "altered", "aux_altered")


def plant(setattr_, fault: str) -> None:
    """Plant `fault` with setattr_(module, name, value)."""
    import ttl_tpu_torch.adapt.ttl as step
    import ttl_tpu_torch.predict as predict
    import ttl_tpu_torch.serve as serve

    if fault == "unchanged":
        setattr_(step, "_adamw",
                 lambda p, g, mu, nu, count, do, lr: (p, mu, nu, count))
    elif fault == "half":
        deyo = step.deyo_loss

        def half(logits, **kw):
            loss, aux = deyo(logits, **kw)
            kept = torch.arange(loss.shape[0], device=loss.device) \
                < loss.shape[0] // 2
            return torch.where(kept, loss, torch.zeros_like(loss)), aux
        setattr_(step, "deyo_loss", half)
    elif fault == "altered":
        softmax = predict.softmax_np

        def shifted(logits):
            return np.roll(softmax(logits), 1, axis=-1)
        setattr_(predict, "softmax_np", shifted)
        setattr_(serve, "softmax_np", shifted)
    elif fault == "aux_altered":
        make = step.make_fused_ttl_fn

        def make_rolled(*a, **kw):
            fused = make(*a, **kw)

            def rolled(*args):
                res = fused(*args)
                return res._replace(zero_shot_logits=torch.roll(
                    res.zero_shot_logits, 1, dims=-1))
            return rolled
        setattr_(step, "make_fused_ttl_fn", make_rolled)
        setattr_(serve, "make_fused_ttl_fn", make_rolled)
    else:
        raise ValueError(f"unknown fault {fault!r}")


class patch:
    """Plant a fault for the length of a `with` block."""

    def __init__(self, fault: str):
        self.fault, self.saved = fault, []

    def _set(self, module, name, value):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def __enter__(self):
        plant(self._set, self.fault)
        return self

    def __exit__(self, *exc):
        for module, name, value in reversed(self.saved):
            setattr(module, name, value)
