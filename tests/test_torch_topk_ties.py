"""Top-k with tied values: the port against the JAX package.

`jax.lax.top_k` puts equal values in the order of their indices, the lower
first. `torch.topk` promises no order among equal values (on the CPU it
returns 135, 132, 133, 134, 131 for the top 5 of 200 zeros), so the port
sorts stably instead. Tied logits are common in bf16; these rows tie on
purpose: integer logits, bf16-rounded logits, constant rows, and DeYO views
that repeat the same row, made with numpy from a seed. The counts and the
kept mask must be equal, the loss and its gradient within f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.ops.entropy import deyo_loss as j_deyo_loss
from ttl_tpu.parallel.eval import make_count_fn
from ttl_tpu_torch.ops.entropy import deyo_loss
from ttl_tpu_torch.parallel.eval import topk_counts


def _tied_logits(kind: str, rng, rows: int, classes: int) -> np.ndarray:
    if kind == "integers":      # three values over 200 classes
        return rng.integers(0, 3, (rows, classes)).astype(np.float32)
    if kind == "bf16":          # logits of CLIP's size, 100 x a cosine,
        # rounded to bf16 (one step is 0.125 between 16 and 32), the top
        # level capped so that every row ties there
        x = 24.0 + 0.13 * rng.standard_normal((rows, classes))
        x = np.minimum(x, 24.2)
        return torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    return np.zeros((rows, classes), np.float32)   # constant rows


@pytest.mark.parametrize("kind", ["integers", "bf16", "constant"])
def test_topk_counts_break_ties_as_jax(kind):
    """Each label is a tied maximal class: the lowest of the tied indices for
    half of the rows (a hit at top-1 under JAX's order), a later one for the
    rest; top-5 likewise with a label sixth or later among the tied."""
    rng = np.random.default_rng(20)
    rows, classes = 48, 200
    logits = _tied_logits(kind, rng, rows, classes)
    labels = np.empty(rows, np.int32)
    for i, row in enumerate(logits):
        tied = np.flatnonzero(row == row.max())
        assert len(tied) > 6, "the rows must tie at their maximum"
        labels[i] = tied[0] if i % 2 == 0 else tied[min(6, len(tied) - 1)]
    valid = np.arange(rows) < rows - 3
    want = np.asarray(make_count_fn()(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      jnp.asarray(valid)))
    got = topk_counts(torch.from_numpy(logits),
                      torch.from_numpy(labels.astype(np.int64)),
                      torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == (rows - 3 + 1) // 2     # the even rows, valid ones


@pytest.mark.parametrize("distinct,p", [(8, 0.1), (4, 0.25), (1, 0.5)])
def test_deyo_filter_ent_keeps_the_lower_views_as_jax(distinct, p):
    """64 views that repeat `distinct` rows: every copy of a row has the same
    entropy to the bit, so `filter_ent` picks among equal values. The kept
    mask must be JAX's (the lower indices), the loss the same, and its
    gradient, which lands only on the kept views, the same."""
    rng = np.random.default_rng(21)
    views, classes = 64, 10
    base = (rng.standard_normal((distinct, classes)) * 2).astype(np.float32)
    logits = base[rng.integers(0, distinct, views)]
    kw = dict(filter_ent=True, selection_p=p)

    def jloss(x):
        return j_deyo_loss(x, **kw)[0]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    _, jaux = j_deyo_loss(jnp.asarray(logits), **kw)
    x = torch.from_numpy(logits).requires_grad_(True)
    got, aux = deyo_loss(x, **kw)
    got.backward()
    np.testing.assert_array_equal(aux["keep"].numpy(),
                                  np.asarray(jaux["keep"]))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)
    kept = np.flatnonzero(aux["keep"].numpy())
    ent = aux["ent"].detach().numpy()
    assert len(np.unique(ent)) == len(np.unique(logits, axis=0))
    # the kept views are the first views of the lowest entropies
    order = sorted(range(views), key=lambda i: (ent[i], i))
    assert kept.tolist() == sorted(order[:int(views * p)])


def test_deyo_filter_ent_batched_ties_match_per_sample():
    """The batched form ([S, N, C]) keeps per sample what the one-sample
    form keeps, ties included."""
    rng = np.random.default_rng(22)
    base = (rng.standard_normal((3, 10)) * 2).astype(np.float32)
    logits = torch.from_numpy(base[rng.integers(0, 3, (4, 32))])
    _, aux = deyo_loss(logits, filter_ent=True, selection_p=0.25)
    for i in range(4):
        _, jaux = j_deyo_loss(jnp.asarray(logits[i].numpy()),
                              filter_ent=True, selection_p=0.25)
        np.testing.assert_array_equal(aux["keep"][i].numpy(),
                                      np.asarray(jaux["keep"]))
