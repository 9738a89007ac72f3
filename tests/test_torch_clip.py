"""The port's CLIP towers against `ttl_tpu.models.clip` on bridged weights.

The vision tower is held against the JAX kernel route: the JAX side runs
under `force_mode("bshd")`, which pads the tokens once per tower (test-tiny:
17 -> 32) and runs the Pallas kernels in interpret mode, as the port pads
and runs its attention. The text tower is causal and both sides use the
einsum numerics. f32 tolerance 1e-4: the same math summed in another order
through 4 layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import prompts as tprompts
from ttl_tpu_torch.models.convert import (adapters_from_numpy,
                                          params_from_numpy, params_to_numpy)
from ttl_tpu_torch.models.zoo import TEST_TINY

WINDOW = (2, 3)
RANK = 4
CLASSES = ["tabby cat", "golden_retriever", "fire truck"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    params = jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY,
                                    param_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    d = J_TINY.vision.hidden
    # B nonzero, so the LoRA terms reach the output
    adapters = {m: {"A": rng.standard_normal((2, d, RANK)).astype(np.float32)
                    * 0.3,
                    "B": rng.standard_normal((2, RANK, d)).astype(np.float32)
                    * 0.3} for m in "qv"}
    images = rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    return _np_tree(params), adapters, images


def _under_bshd(fn, *args):
    with jfa.force_mode("bshd"):
        return np.array(jax.jit(fn)(*args))


def test_vision_prefix_matches_jax(setup):
    params, _, images = setup
    want = _under_bshd(lambda p, x: jclip.vision_prefix(
        p, x, J_TINY.vision, upto=2, compute_dtype=jnp.float32),
        params["vision"], images)
    tp = params_from_numpy(params, "cpu")
    got = tclip.vision_prefix(tp["vision"], torch.from_numpy(images),
                              TEST_TINY.vision, upto=2,
                              compute_dtype=torch.float32)
    assert got.shape == want.shape == (3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_vision_from_hidden_with_adapters_matches_jax(setup):
    params, adapters, images = setup
    hidden = _under_bshd(lambda p, x: jclip.vision_prefix(
        p, x, J_TINY.vision, upto=WINDOW[0], compute_dtype=jnp.float32),
        params["vision"], images)
    want = _under_bshd(lambda p, h, a: jclip.vision_from_hidden(
        p, h, J_TINY.vision, adapters=a, adapter_window=WINDOW,
        lora_scale=2.0), params["vision"], hidden, adapters)
    tp = params_from_numpy(params, "cpu")
    got = tclip.vision_from_hidden(
        tp["vision"], torch.from_numpy(hidden), TEST_TINY.vision,
        adapters=adapters_from_numpy(adapters, "cpu"),
        adapter_window=WINDOW, lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_per_sample_adapters_match_one_set_each(setup):
    """[S, L, ...] adapters over S groups of rows == each set on its own."""
    params, adapters, images = setup
    tp = params_from_numpy(params, "cpu")["vision"]
    hidden = tclip.vision_prefix(tp, torch.from_numpy(images[:2]),
                                 TEST_TINY.vision, upto=WINDOW[0],
                                 compute_dtype=torch.float32)
    ad = adapters_from_numpy(adapters, "cpu")
    ad2 = tclip.tree_map(lambda a: torch.stack([a, 0.5 * a]), ad)
    both = tclip.vision_from_hidden(tp, hidden, TEST_TINY.vision,
                                    adapters=ad2, adapter_window=WINDOW)
    for i, scale in enumerate((1.0, 0.5)):
        one = tclip.vision_from_hidden(
            tp, hidden[i:i + 1], TEST_TINY.vision,
            adapters=tclip.tree_map(lambda a: scale * a, ad),
            adapter_window=WINDOW)
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_vision_features_matches_jax(setup):
    params, _, images = setup
    want = _under_bshd(lambda p, x: jclip.vision_features(
        p, x, J_TINY.vision, compute_dtype=jnp.float32),
        params["vision"], images)
    tp = params_from_numpy(params, "cpu")
    got = tclip.vision_features(tp["vision"], torch.from_numpy(images),
                                TEST_TINY.vision,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_text_features_and_classifier_match_jax(setup):
    params, _, _ = setup
    toks = tprompts.prompt_tokens(CLASSES)
    np.testing.assert_array_equal(toks, jprompts.prompt_tokens(CLASSES))
    n = tprompts.needed_ctx_len(toks)
    assert n == jprompts.needed_ctx_len(toks) == 16
    tp = params_from_numpy(params, "cpu")
    want = np.asarray(jclip.text_features(
        params["text"], jnp.asarray(toks[:, :n]), J_TINY.text,
        compute_dtype=jnp.float32))
    got = tclip.text_features(tp["text"], torch.from_numpy(
        toks[:, :n].astype(np.int64)), TEST_TINY.text,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    want_cls = np.asarray(jprompts.build_text_classifier(
        params["text"], jnp.asarray(toks), J_TINY.text,
        compute_dtype=jnp.float32))
    got_cls = tprompts.build_text_classifier(
        tp["text"], toks, TEST_TINY.text, device="cpu",
        compute_dtype=torch.float32, batch=2)
    np.testing.assert_allclose(got_cls.numpy(), want_cls, rtol=1e-4,
                               atol=1e-4)


def test_cosine_logits_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((3, 16)).astype(np.float32)
    txt = rng.standard_normal((5, 16)).astype(np.float32)
    scale = np.float32(np.log(1 / 0.07))
    want = np.asarray(jclip.cosine_logits(jnp.asarray(img), jnp.asarray(txt),
                                          jnp.asarray(scale)))
    got = tclip.cosine_logits(torch.from_numpy(img), torch.from_numpy(txt),
                              torch.tensor(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_vision_features_close_to_jax(setup):
    """bf16 weights and activations on both sides. bf16 keeps 8 bits of
    mantissa (relative step 2^-8 = 3.9e-3); XLA and torch round the same
    ops but accumulate their bf16 matmuls differently, so single roundings
    differ by an ulp and compound over 4 layers. The bound is 4 ulps of the
    largest feature (1.6e-2 relative), where a wrong formula is off by
    order 1."""
    params, adapters, images = setup
    pbf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                       if a.ndim >= 2 else jnp.asarray(a), params["vision"])
    want = _under_bshd(lambda p, x, a: jclip.vision_features(
        p, x, J_TINY.vision, adapters=a, adapter_window=WINDOW,
        compute_dtype=jnp.bfloat16), pbf, images, adapters)
    tp = params_from_numpy(_np_tree(pbf), "cpu")
    assert tp["patch_embed"].dtype == torch.bfloat16
    got = tclip.vision_features(tp, torch.from_numpy(images),
                                TEST_TINY.vision,
                                adapters=adapters_from_numpy(adapters, "cpu"),
                                adapter_window=WINDOW,
                                compute_dtype=torch.bfloat16)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -8 * scale)


def test_weight_bridge_round_trip():
    params = jclip.init_clip_params(jax.random.PRNGKey(1), J_TINY,
                                    param_dtype=jnp.bfloat16)
    tp = params_from_numpy(_np_tree(params), "cpu")
    assert tp["vision"]["layers"]["attn"]["q"]["w"].dtype == torch.bfloat16
    assert tp["vision"]["ln_pre"]["scale"].dtype == torch.float32
    back = params_to_numpy(tp)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b,
                                      err_msg=str(path))
    cast = params_from_numpy(_np_tree(params), "cpu",
                             param_dtype=torch.float32)
    assert cast["text"]["token_embed"].dtype == torch.float32


def test_ensemble_classifier_matches_jax(setup, monkeypatch):
    """3 templates x 3 classes, one global EOT-truncated length, f32; the 9
    prompts go through the text tower in batches of 4."""
    params, _, _ = setup
    monkeypatch.setattr(tprompts, "ENSEMBLE_BATCH", 4)
    templates = ["a photo of a {}.", "a drawing of the {}.",
                 "itap of my {} in the garden."]
    want = np.asarray(jprompts.build_ensemble_classifier(
        params["text"], CLASSES, J_TINY.text, templates=templates,
        compute_dtype=jnp.float32))
    tp = params_from_numpy(params, "cpu")
    got = tprompts.build_ensemble_classifier(
        tp["text"], CLASSES, TEST_TINY.text, device="cpu",
        templates=templates, compute_dtype=torch.float32)
    assert got.shape == (3, TEST_TINY.text.proj_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert tprompts.load_imagenet_templates() == \
        jprompts.load_imagenet_templates()
