"""The port's repairs of functions it lacked, against `ttl_tpu`.

- `ops/entropy.py::data_uncertainty` and `::quartile_selection`, with tied
  entropies (stable order, as `jnp.argsort`);
- the numerics switches `TTL_LN_STATS`, `TTL_LORA_COMPUTE` and
  `TTL_ATTN_SCORES`, each value set on both sides (the JAX functions read
  the environment at each call when they are not jitted), and the port's
  ValueError on an unknown value;
- `models/clip.py::fuse_qkv_params` and the fused `qkv` layer: the tower,
  the LoRA q/v split, the int8 prefix beside fused fp layers, the fused
  layernorm route, and the weight bridge of a fused leaf;
- `zero_shot_aux` on the batched LoRA step, image and text mode;
- `init_prompt_learner(truncate=False)`.

Tolerances: f32 1e-5 of the output's scale where one layer or function is
compared, 5e-4 through a whole step (tests/test_torch_adapt.py); bf16 four
bf16 steps (2^-8 relative each) of the output's scale: XLA and torch both
accumulate bf16 products in f32 and round once, in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.adapt.ttl import make_batched_ttl_fn as j_make_batched
from ttl_tpu.config import TTLConfig
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops import entropy as jent
from ttl_tpu.ops import quant as jq
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import prompts as tprompts
from ttl_tpu_torch.models.convert import (adapters_from_numpy,
                                          params_from_numpy)
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops import attention as tfa
from ttl_tpu_torch.ops import entropy as tent
from ttl_tpu_torch.ops import quant as tq

S, V, RANK, WINDOW = 2, 8, 4, (2, 3)
CLASSES = ["tabby cat", "golden_retriever", "fire truck"]
BF16_BOUND = 4 * 2.0 ** -8


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    params = _np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY,
                                             param_dtype=jnp.float32))
    rng = np.random.default_rng(3)
    d = J_TINY.vision.hidden
    adapters = {m: {"A": rng.standard_normal((2, d, RANK)).astype(np.float32)
                    * 0.3,
                    "B": rng.standard_normal((2, RANK, d)).astype(np.float32)
                    * 0.3} for m in "qv"}
    views = (rng.standard_normal((S, V, 3, 64, 64)) * 0.6).astype(np.float32)
    return params, adapters, views


# ------------------------------------------------------------------ entropy

def test_data_uncertainty_matches_jax():
    logits = (np.random.default_rng(0).standard_normal((3, 16, 7)) * 3
              ).astype(np.float32)
    got = tent.data_uncertainty(torch.from_numpy(logits))
    assert got.shape == (3,)
    for i in range(3):
        want = float(jent.data_uncertainty(jnp.asarray(logits[i])))
        np.testing.assert_allclose(got[i].item(), want, rtol=1e-6)


@pytest.mark.parametrize("quartile", [0, 3, 7, 9])
def test_quartile_selection_matches_jax_with_ties(quartile):
    """Rows repeat, so entropies tie; 20 rows in 8 chunks of 2 leave 4 rows
    out; quartile 9 lies past the last chunk and is clamped to it."""
    rng = np.random.default_rng(1)
    base = (rng.standard_normal((5, 6)) * 2).astype(np.float32)
    logits = base[rng.integers(0, 5, 20)]
    want = np.asarray(jent.quartile_selection(jnp.asarray(logits), quartile))
    got = tent.quartile_selection(torch.from_numpy(logits), quartile)
    np.testing.assert_array_equal(got.numpy(), want)
    batched = tent.quartile_selection(
        torch.from_numpy(np.stack([logits, logits[::-1].copy()])), quartile)
    np.testing.assert_array_equal(batched[0].numpy(), want)


# ----------------------------------------------------------------- switches

@pytest.mark.parametrize("mode", ["centered", "ex2"])
def test_layer_norm_stats_switch_matches_jax(monkeypatch, mode):
    """Rows of 64 + k/4 (k in [-8, 8]): every sum of x, of (x - mu)^2 and
    of x^2 is exact in f32 in any order, so both sides agree to the
    rounding of the last steps, while mu^2 (4096 and up, in steps of
    2^-16) rounds: E[x^2] - mu^2 then differs from the centered variance,
    and the two settings give outputs more than ten times the bound
    apart."""
    monkeypatch.setenv("TTL_LN_STATS", mode)
    rng = np.random.default_rng(2)
    x = (64.0 + rng.integers(-8, 9, (4, 5, 64)) / 4.0).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = np.asarray(jclip.layer_norm(jnp.asarray(x), p, 1e-5))
    got = tclip.layer_norm(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           1e-5).numpy()
    bound = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    monkeypatch.setenv("TTL_LN_STATS", "ex2" if mode == "centered"
                       else "centered")
    other = tclip.layer_norm(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()},
                             1e-5).numpy()
    assert np.abs(other - got).max() > 10 * bound


def _layer_bf16(params, i):
    return jax.tree.map(lambda a: a[i], params["vision"]["layers"])


@pytest.mark.parametrize("mode", ["mixed", "f32"])
def test_lora_compute_switch_matches_jax(monkeypatch, model, mode):
    """One bf16 vision layer with LoRA on q and v: 'mixed' rounds A to bf16,
    'f32' keeps it; both sides on the einsum attention. The two settings
    move outputs by about a bf16 step, the size of the bound, so the port
    must also agree with JAX's same setting bit for bit on more elements
    than with its other one: at this seed 62 and 48 of 1088 elements differ
    from the same setting, about 550 from the other."""
    params, adapters, _ = model
    layer = _layer_bf16(params, 2)
    lora = jax.tree.map(lambda a: a[0], adapters)
    x = (np.random.default_rng(4).standard_normal((2, 17, 32)) * 0.5
         ).astype(np.float32)
    jlayer = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                          if a.ndim >= 2 else jnp.asarray(a), layer)

    def jax_layer(setting):
        monkeypatch.setenv("TTL_LORA_COMPUTE", setting)
        with jfa.force_mode(""):
            return np.asarray(jclip.encoder_layer(
                jlayer, jnp.asarray(x, jnp.bfloat16), heads=2, eps=1e-5,
                causal=False, lora=jax.tree.map(jnp.asarray, lora),
                lora_scale=8.0).astype(jnp.float32))

    other = jax_layer("f32" if mode == "mixed" else "mixed")
    want = jax_layer(mode)
    tlayer = params_from_numpy(layer, "cpu", torch.bfloat16)
    with tfa.force_mode(""):
        got = tclip.encoder_layer(
            tlayer, torch.from_numpy(x).bfloat16(), heads=2, eps=1e-5,
            causal=False, lora=adapters_from_numpy(lora, "cpu"),
            lora_scale=8.0).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_BOUND * np.abs(want).max())
    assert 4 * (got != want).sum() < (got != other).sum()


@pytest.mark.parametrize("mode", ["low", "f32"])
def test_attn_scores_switch_matches_jax(monkeypatch, mode):
    """The einsum attention on bf16 inputs stores its scores in bf16 from a
    pre-scaled q ('low') or in f32 ('f32'); scores of about 30 make the two
    differ."""
    monkeypatch.setenv("TTL_ATTN_SCORES", mode)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 4, 33, 16)).astype(np.float32)
               * s for s in (4.0, 4.0, 1.0))
    jq_, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jfa.reference_attention(jq_, jk, jv, causal=True)
                      .astype(jnp.float32))

    def merged(t):
        return torch.from_numpy(t).bfloat16().transpose(1, 2).reshape(
            2, 33, 64)

    def run():
        out = tfa.einsum_attention_plain(merged(q), merged(k), merged(v), 4,
                                         causal=True)
        return out.float().reshape(2, 33, 4, 16).transpose(1, 2).numpy()

    got = run()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_BOUND * np.abs(want).max())
    monkeypatch.setenv("TTL_ATTN_SCORES", "f32" if mode == "low" else "low")
    assert np.abs(run() - got).max() > BF16_BOUND * np.abs(want).max()


@pytest.mark.parametrize("name", ["TTL_LN_STATS", "TTL_LORA_COMPUTE",
                                  "TTL_ATTN_SCORES"])
def test_unknown_switch_value_raises(monkeypatch, model, name):
    """The JAX package falls back to the default on an unknown value; the
    port raises, in the function that reads it and before any work in
    `runner.run`."""
    params, adapters, _ = model
    monkeypatch.setenv(name, "bogus")
    x = torch.zeros(1, 17, 32, dtype=torch.bfloat16)
    layer = params_from_numpy(_layer_bf16(params, 2), "cpu", torch.bfloat16)
    with pytest.raises(ValueError, match=name), tfa.force_mode(""):
        tclip.encoder_layer(layer, x, heads=2, eps=1e-5, causal=False,
                            lora=adapters_from_numpy(
                                jax.tree.map(lambda a: a[0], adapters),
                                "cpu"))
    cfg = trunner.TTLConfig(arch="test-tiny", resolution=64)
    monkeypatch.setattr(trunner, "load_model", lambda *a: pytest.fail(
        "runner.run went on past the unknown switch"))
    with pytest.raises(ValueError, match=name):
        trunner.run(cfg, device="cpu")


# ------------------------------------------------------------ fused q, k, v

def test_fuse_qkv_params_matches_jax_and_bridges(model):
    """The port's fused tower equals JAX's fused tower bridged leaf by leaf,
    and both towers give the unfused features."""
    params, _, views = model
    jfused = _np_tree(jclip.fuse_qkv_params(params["vision"]))
    assert set(jfused["layers"]["attn"]) == {"qkv", "o"}
    bridged = params_from_numpy(jfused, "cpu")
    fused = tclip.fuse_qkv_params(params_from_numpy(params, "cpu")["vision"])
    for key in ("w", "b"):
        assert torch.equal(fused["layers"]["attn"]["qkv"][key],
                           bridged["layers"]["attn"]["qkv"][key])
    imgs = views[0, :3]
    with jfa.force_mode("bshd"):
        want = np.asarray(jax.jit(lambda p, x: jclip.vision_features(
            p, x, J_TINY.vision, compute_dtype=jnp.float32))(jfused, imgs))
    got = tclip.vision_features(fused, torch.from_numpy(imgs),
                                TEST_TINY.vision, compute_dtype=torch.float32)
    unfused = tclip.vision_features(
        params_from_numpy(params, "cpu")["vision"], torch.from_numpy(imgs),
        TEST_TINY.vision, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=0,
                               atol=1e-5)


def test_fused_qkv_lora_window_matches_jax(model):
    """LoRA on a fused layer adds its q and v updates to the q and v thirds
    of the fused product: the window forward from a cached prefix with
    B nonzero, against JAX on the same fused tower."""
    params, adapters, views = model
    jfused = _np_tree(jclip.fuse_qkv_params(params["vision"]))
    imgs = views[0, :3]

    def jax_window(p, x, ad):
        hidden = jclip.vision_prefix(p, x, J_TINY.vision, upto=WINDOW[0],
                                     compute_dtype=jnp.float32)
        return jclip.vision_from_hidden(p, hidden, J_TINY.vision,
                                        adapters=ad, adapter_window=WINDOW,
                                        lora_scale=8.0)

    with jfa.force_mode("bshd"):
        want = np.asarray(jax.jit(jax_window)(jfused, imgs, adapters))
    fused = params_from_numpy(jfused, "cpu")
    hidden = tclip.vision_prefix(fused, torch.from_numpy(imgs),
                                 TEST_TINY.vision, upto=WINDOW[0],
                                 compute_dtype=torch.float32)
    got = tclip.vision_from_hidden(fused, hidden, TEST_TINY.vision,
                                   adapters=adapters_from_numpy(adapters,
                                                                "cpu"),
                                   adapter_window=WINDOW, lora_scale=8.0)
    without = tclip.vision_from_hidden(fused, hidden, TEST_TINY.vision,
                                       adapter_window=WINDOW)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got - without).abs().max() > 1e-2   # the adapters reach it


def test_fused_qkv_with_int8_prefix_matches_jax(model):
    """Quantising a fused tower raises on both sides; a tower quantised
    first and fused after runs its int8 prefix and its fused fp layers, as
    JAX's does."""
    params, _, views = model
    with pytest.raises(ValueError, match="fuse_qkv"):
        jq.attach_prefix_quant({**params, "vision": jclip.fuse_qkv_params(
            params["vision"])}, 2)
    with pytest.raises(ValueError, match="fuse_qkv"):
        tq.attach_prefix_quant({"vision": tclip.fuse_qkv_params(
            params_from_numpy(params, "cpu")["vision"])}, 2)
    qparams = _np_tree(jq.attach_prefix_quant(params, 2))
    jvision = _np_tree(jclip.fuse_qkv_params(qparams["vision"]))
    imgs = views[0, :3]
    with jfa.force_mode("bshd"):
        want = np.asarray(jax.jit(lambda p, x: jclip.vision_prefix(
            p, x, J_TINY.vision, upto=3, compute_dtype=jnp.float32))(
                jvision, imgs))
    tvision = tclip.fuse_qkv_params(params_from_numpy(qparams,
                                                      "cpu")["vision"])
    assert "prefix_q" in tvision
    got = tclip.vision_prefix(tvision, torch.from_numpy(imgs),
                              TEST_TINY.vision, upto=3,
                              compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy()[:, :17], want[:, :17], rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_fused_qkv_under_fused_ln_takes_one_product(model, monkeypatch):
    """Under `fold="f32"` a fused layer's q, k and v come from one
    layernorm + linear call: two calls a layer instead of four, the same
    features."""
    params, _, views = model
    calls = []
    real = tclip.ln_matmul

    def counting(*args, **kw):
        calls.append(args[3].shape[-1])
        return real(*args, **kw)

    monkeypatch.setattr(tclip, "ln_matmul", counting)
    tparams = params_from_numpy(params, "cpu")["vision"]
    imgs = torch.from_numpy(views[0, :3])
    with torch.no_grad():
        # the reference, q, k and v apart, folds with `linear`'s epilogue
        # (the frozen tower's own route): four calls a layer
        plain = tclip.encode_image(tparams, imgs, TEST_TINY.vision,
                                   compute_dtype=torch.float32)
        assert calls == [32, 32, 32, 128] * J_TINY.vision.layers
        calls.clear()
        got = tclip.encode_image(tclip.fuse_qkv_params(tparams), imgs,
                                 TEST_TINY.vision,
                                 compute_dtype=torch.float32, fold="f32")
    assert calls == [96, 128] * J_TINY.vision.layers
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------ zero_shot_aux

def _cfg(**kw):
    return TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                     layer_range=WINDOW, rank=RANK, compute_dtype="float32",
                     param_dtype="float32", **kw)


@pytest.mark.parametrize("encoder", ["image", "text"])
def test_zero_shot_aux_matches_jax(model, encoder):
    """zero_shot_aux: the clean view's logits without adapters, beside the
    adapted ones; without it the port returns None and the JAX package
    zeros."""
    params, _, views = model
    width = (J_TINY.vision if encoder == "image" else J_TINY.text).hidden
    adapters0 = _np_tree(j_init_adapters(jax.random.PRNGKey(1), 2, width,
                                         RANK, "xavier"))
    cfg = _cfg(tta_steps=1, lora_encoder=encoder)
    tokens = np.asarray(jprompts.prompt_tokens(CLASSES))
    text_cls = np.random.default_rng(8).standard_normal(
        (len(CLASSES), J_TINY.vision.proj_dim))
    text_cls = (text_cls / np.linalg.norm(text_cls, axis=-1, keepdims=True)
                ).astype(np.float32)
    with jfa.force_mode("bshd"):
        res = j_make_batched(J_TINY, cfg, tokens=jnp.asarray(tokens),
                             zero_shot_aux=True)(
            params, jnp.asarray(text_cls), adapters0, jnp.asarray(views),
            jax.random.split(jax.random.PRNGKey(9), S))
    want, want_zs = np.asarray(res.logits), np.asarray(res.zero_shot_logits)
    tp = params_from_numpy(params, "cpu")
    args = (tp, None if encoder == "text" else torch.from_numpy(text_cls),
            adapters_from_numpy(adapters0, "cpu"), torch.from_numpy(views))
    got = make_batched_ttl_fn(TEST_TINY, cfg, tokens=tokens,
                              zero_shot_aux=True)(*args)
    assert got.zero_shot_logits.shape == (S, len(CLASSES))
    np.testing.assert_allclose(got.zero_shot_logits.numpy(), want_zs,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.logits.numpy(), want, rtol=5e-4,
                               atol=5e-4)
    assert np.abs(want - want_zs).max() > 1e-3   # the two figures differ
    assert make_batched_ttl_fn(TEST_TINY, cfg, tokens=tokens)(
        *args).zero_shot_logits is None


# ------------------------------------------------------------ prompt learner

@pytest.mark.parametrize("learned_cls", [False, True])
def test_init_prompt_learner_without_truncation_matches_jax(model,
                                                            learned_cls):
    params, _, _ = model
    embed = np.array(params["text"]["token_embed"])
    want = jprompts.init_prompt_learner(jnp.asarray(embed), CLASSES,
                                        learned_cls=learned_cls,
                                        truncate=False)
    got = tprompts.init_prompt_learner(torch.from_numpy(embed), CLASSES,
                                       learned_cls=learned_cls,
                                       truncate=False)
    assert got.tokenized.shape == (len(CLASSES), 77)
    np.testing.assert_array_equal(got.tokenized.numpy(),
                                  np.asarray(want.tokenized))
    for name in ("prefix", "suffix", "ctx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    short = tprompts.init_prompt_learner(torch.from_numpy(embed), CLASSES,
                                         learned_cls=learned_cls)
    assert short.tokenized.shape[1] < 77
