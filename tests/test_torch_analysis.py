"""The port's offline analysis (`ttl_tpu_torch/utils/analysis.py`) against
`ttl_tpu/utils/analysis.py` on the same inputs: the attention maps of the
tiny ViT on JAX's weights, the rollout (with discard_ratio 0 and 0.1, and
at ties on the threshold), the heatmap overlay and the t-SNE embedding,
within 1e-5 (t-SNE 1e-4); the port's jet colours against matplotlib's; and
the cases of tests/test_analysis.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.utils import analysis as janalysis
from ttl_tpu_torch.models.convert import params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.utils.analysis import (attention_rollout, heatmap_overlay,
                                          jet, tsne_features,
                                          vision_attention_maps)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    images = np.random.default_rng(1).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(janalysis.vision_attention_maps(
        params["vision"], jnp.asarray(images), J_TINY.vision))
    got = vision_attention_maps(params_from_numpy(params, "cpu")["vision"],
                                torch.from_numpy(images), TEST_TINY.vision)
    return want, got


def test_attention_maps_match_jax(setup):
    want, got = setup
    v = TEST_TINY.vision
    assert got.shape == (v.layers, 2, v.heads, v.seq_len, v.seq_len)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # rows are probability distributions
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("discard_ratio", [0.0, 0.1])
def test_attention_rollout_matches_jax(setup, discard_ratio):
    want_maps, _ = setup
    want = np.asarray(janalysis.attention_rollout(jnp.asarray(want_maps),
                                                  discard_ratio))
    got = attention_rollout(torch.from_numpy(want_maps.copy()),
                            discard_ratio)
    assert got.shape == (2, TEST_TINY.vision.seq_len - 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    r = got.numpy()
    assert np.isfinite(r).all() and r.max() <= 1.0 + 1e-6 and r.min() >= 0


def test_attention_rollout_keeps_values_tied_with_the_threshold():
    """Maps of a few distinct values, so that many equal the k-th smallest:
    those stay, only the smaller ones are zeroed, as in JAX."""
    rng = np.random.default_rng(4)
    maps = rng.integers(1, 4, (3, 2, 2, 5, 5)).astype(np.float32) / 4.0
    for ratio in (0.1, 0.3, 0.5):
        want = np.asarray(janalysis.attention_rollout(jnp.asarray(maps),
                                                      ratio))
        got = attention_rollout(torch.from_numpy(maps), ratio).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw", [(64, 64), (50, 72)])
def test_heatmap_overlay_matches_jax(setup, hw):
    want_maps, _ = setup
    rel = np.asarray(janalysis.attention_rollout(jnp.asarray(want_maps)))[0]
    img01 = np.random.RandomState(0).rand(*hw, 3).astype(np.float32)
    want = janalysis.heatmap_overlay(img01, rel)
    got = heatmap_overlay(img01, rel)
    assert got.shape == hw + (3,)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, **TOL)


def test_jet_is_matplotlibs_jet():
    """Every level, both sides of each level's boundary, and x = 1, in f32
    as the overlay passes it and in f64."""
    import matplotlib.cm as cm
    edges = np.arange(257) / 256
    for dtype in (np.float32, np.float64):
        x = np.concatenate([np.linspace(0, 1, 4097), edges,
                            np.nextafter(edges, -1), np.nextafter(edges, 2)])
        x = np.clip(x, 0, 1).astype(dtype)
        np.testing.assert_allclose(jet(x), cm.jet(x)[..., :3], rtol=0,
                                   atol=1e-12)


def test_tsne_matches_jax(tmp_path):
    feats = np.random.RandomState(0).randn(30, 16).astype(np.float32)
    labels = [i % 3 for i in range(30)]
    out = tmp_path / "tsne.png"
    got = tsne_features(feats, labels, str(out))
    want = janalysis.tsne_features(feats, labels)
    assert got.shape == (30, 2)
    assert out.exists() and out.stat().st_size > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
