"""The ResNet CLIP towers (RN50 family) of the port against `ttl_tpu`, on
the CPU.

A tiny tower (`layers (1, 1, 1, 1)`, width 16, 4 heads, proj 32, 64-pixel
images, as tests/test_resnet.py's CFG_TINY) with JAX's own weights, the
batchnorms given running statistics that are not the identity, bridged
across (HWIO conv kernels to OIHW); the same numpy inputs on both sides.

Tolerances:
- `_avgpool2` and `_bn` in bf16: bit for bit (the pool sums its taps in
  XLA's row-major order, one bf16 rounding each; the fold is the same f32
  arithmetic); `_bn` in f32: equal eagerly, and rtol 1e-5, since XLA may
  evaluate the fold otherwise under jit.
- Bottlenecks, the attention pool and `resnet_features` in f32: rtol/atol
  1e-5 (convolutions and f32 products summed in another order).
- `resnet_features` in bf16: one bf16 step (2^-8) of the largest feature.
  Every bf16 stage rounds as JAX's does, so the two agree unless an
  accumulation lands an activation a rounding the other way; one such
  step, carried through the stages above it, moves a feature by about one
  bf16 step of the features' scale.
- The fused steps (TPT, text-LoRA, zero-shot, CoCoOp) from uint8 canvases
  with JAX's view draws, and `runner.evaluate_dataset`: 5e-4 in f32, the
  bound of tests/test_torch_text.py (forward, backward and AdamW in another
  order); equal top-1/top-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_threads  # noqa: F401  (torch threads per worker)
from test_torch_image import jax_draws, stack_draws

import ttl_tpu.parallel.eval as jeval
from ttl_tpu import runner as jrunner
from ttl_tpu.adapt import cocoop as jco
from ttl_tpu.adapt import ttl as jttl
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.data.views import ArrayDataset as JArrayDataset
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.models import resnet as jrn
from ttl_tpu.models import zoo as jzoo
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt import ttl as tttl
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import resnet as trn
from ttl_tpu_torch.models import zoo as tzoo
from ttl_tpu_torch.models.convert import (adapters_from_numpy,
                                          cocoop_state_from_numpy,
                                          params_from_numpy, params_to_numpy,
                                          prompt_learner_from_numpy)
from ttl_tpu_torch.ops import attention as tfa

RN_TINY = trn.ResNetVisionConfig(layers=(1, 1, 1, 1), width=16, heads=4,
                                 proj_dim=32, image_size=64)
J_RN_TINY = jrn.ResNetVisionConfig(layers=(1, 1, 1, 1), width=16, heads=4,
                                   proj_dim=32, image_size=64)
# the tiny text tower, projecting to the vision tower's 32
CLIP_TINY = tclip.CLIPConfig(
    vision=RN_TINY,
    text=dataclasses.replace(tzoo.TEST_TINY.text, proj_dim=32))
J_CLIP_TINY = jclip.CLIPConfig(
    vision=J_RN_TINY,
    text=dataclasses.replace(jzoo.TEST_TINY.text, proj_dim=32))
CLASSES = ["goldfish", "great white shark", "tree_frog", "box turtle",
           "American alligator", "hen"]
V, RANK = 8, 4
SIZES = [(80, 80), (50, 72)]   # full canvas, wide
F32 = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=5e-4, atol=5e-4)


def _statistics(tree, rng):
    """Every batchnorm of a JAX-layout tree given drawn running statistics
    and affine parameters, so that the fold does arithmetic."""
    if isinstance(tree, dict) and "var" in tree:
        n = tree["var"].shape
        return {"scale": (1 + 0.2 * rng.standard_normal(n)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    if isinstance(tree, dict):
        return {k: _statistics(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_statistics(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def model():
    """JAX's tiny CLIP with the ResNet tower, as numpy leaves."""
    params = jax.tree.map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_CLIP_TINY, param_dtype=jnp.float32))
    params["vision"] = _statistics(params["vision"],
                                   np.random.default_rng(1))
    return params


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _canvases(seed):
    rng = np.random.default_rng(seed)
    canv = np.zeros((len(SIZES), 80, 80, 3), np.uint8)
    for i, (h, w) in enumerate(SIZES):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return (canv, np.array([h for h, _ in SIZES], np.int32),
            np.array([w for _, w in SIZES], np.int32))


def _cfgs(**kw):
    """The JAX package's config and the port's, with the same fields."""
    kw = dict(arch="test-tiny", resolution=64, batch_size=V, rank=RANK,
              compute_dtype="float32", param_dtype="float32",
              selection_p=0.4, seed=5, **kw)
    return JTTLConfig(**kw), TTLConfig(**kw)


# ----------------------------------------------------------------- pieces

@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 8, 7, 9)])
def test_avgpool2_bf16_is_bit_for_bit(shape):
    """Odd sizes drop the last row and column, as reduce_window's VALID."""
    x = (np.random.default_rng(2).standard_normal(shape) * 3).astype(
        np.float32)
    want = np.asarray(jrn._avgpool2(jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    got = trn._avgpool2(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bn_matches_jax(model, dtype):
    p = model["vision"]["layer1"][0]["bn2"]
    x = (np.random.default_rng(3).standard_normal((2, 16, 8, 8)) * 2).astype(
        np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                   dtype))
    tp = params_from_numpy(p, "cpu")
    got = trn._bn(tx, tp).float().numpy()
    want = np.asarray(jrn._bn(jx, _jtree(p)).astype(jnp.float32))
    jitted = np.asarray(jax.jit(jrn._bn)(jx, _jtree(p)).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, jitted)
    else:
        np.testing.assert_allclose(got, jitted, rtol=1e-5, atol=0)


@pytest.mark.parametrize("stage,stride", [(1, 1), (2, 2)])
def test_bottleneck_matches_jax(model, stage, stride):
    """layer1's block (stride 1; a downsample, as the first block of every
    stage) and layer2's (stride 2: pools on both branches)."""
    bp = model["vision"][f"layer{stage}"][0]
    assert "downsample" in bp
    cin = bp["conv1"].shape[2]
    x = np.random.default_rng(4).standard_normal((2, cin, 16, 16)).astype(
        np.float32)
    want = np.asarray(jrn.bottleneck(_jtree(bp), jnp.asarray(x), stride))
    tp = params_from_numpy(model["vision"], "cpu")[f"layer{stage}"][0]
    got = trn.bottleneck(tp, torch.from_numpy(x), stride).numpy()
    assert got.shape == want.shape == (2, bp["conv3"].shape[3],
                                       16 // stride, 16 // stride)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_attention_pool_matches_jax(model, param_dtype):
    """f32 weights (random init) and bf16 ones (a checkpoint's matrices at
    param_dtype bfloat16, its biases f32), on bf16 tokens."""
    ap = model["vision"]["attnpool"]
    tp = params_from_numpy(ap, "cpu", getattr(torch, param_dtype))
    jp = jax.tree.map(lambda a: jnp.asarray(
        a, param_dtype if a.ndim >= 2 else jnp.float32), ap)
    x = np.random.default_rng(5).standard_normal(
        (2, RN_TINY.feat_dim, 2, 2)).astype(np.float32)
    want = np.asarray(jrn.attention_pool(
        jp, jnp.asarray(x, jnp.bfloat16), RN_TINY.heads))
    got = trn.attention_pool(tp, torch.from_numpy(x).bfloat16(),
                             RN_TINY.heads)
    assert got.dtype == torch.float32 and got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_features_match_jax(model, dtype):
    x = np.random.default_rng(6).standard_normal((3, 3, 64, 64)).astype(
        np.float32)
    want = np.asarray(jrn.resnet_features(
        _jtree(model["vision"]), jnp.asarray(x), J_RN_TINY,
        compute_dtype=getattr(jnp, dtype)))
    got = trn.resnet_features(params_from_numpy(model["vision"], "cpu"),
                              torch.from_numpy(x), RN_TINY,
                              compute_dtype=getattr(torch, dtype)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_encode_image_dispatches_a_resnet_tower(model):
    """encode_image takes the ResNet path (fold="f32", which CoCoOp passes,
    has nothing to fold there) and refuses adapters as JAX does."""
    x = np.random.default_rng(7).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    tp = params_from_numpy(model["vision"], "cpu")
    want = np.asarray(jclip.encode_image(_jtree(model["vision"]),
                                         jnp.asarray(x), J_RN_TINY,
                                         compute_dtype=jnp.float32))
    for fold in (None, "f32"):
        got = tclip.encode_image(tp, torch.from_numpy(x), RN_TINY,
                                 compute_dtype=torch.float32, fold=fold)
        np.testing.assert_allclose(got.numpy(), want, **F32)
    with pytest.raises(ValueError, match="ViT backbone"):
        jclip.encode_image(_jtree(model["vision"]), jnp.asarray(x),
                           J_RN_TINY, adapters={"q": {}})
    with pytest.raises(ValueError, match="ViT backbone"):
        tclip.encode_image(tp, torch.from_numpy(x), RN_TINY,
                           adapters={"q": {}})


def test_bridge_round_trip_and_layout(model):
    """HWIO <-> OIHW on the conv kernels only; lists of blocks kept."""
    tp = params_from_numpy(model, "cpu")
    assert isinstance(tp["vision"]["layer1"], list)
    assert tuple(tp["vision"]["conv1"].shape) == (8, 3, 3, 3)
    assert tuple(tp["vision"]["attnpool"]["q"]["w"].shape) == (512, 512)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(model)):
        np.testing.assert_array_equal(a, b)


def test_init_keeps_the_jax_dtype_rule():
    """Random init at param_dtype bfloat16: convs bf16 (OIHW, the JAX
    shapes moved), batchnorms and the whole attention pool f32, the text
    tower as the ViT's."""
    got = tclip.init_clip_params(CLIP_TINY, torch.Generator().manual_seed(0),
                                 device="cpu", param_dtype=torch.bfloat16)
    want = jclip.init_clip_params(jax.random.PRNGKey(0), J_CLIP_TINY,
                                  param_dtype=jnp.bfloat16)
    got_np = params_to_numpy(got)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for (path, w), g, t in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree.leaves(got_np),
            jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(w.dtype), \
            jax.tree_util.keystr(path)
    assert got["vision"]["attnpool"]["q"]["w"].dtype == torch.float32
    assert got["vision"]["layer4"][0]["conv2"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4", "RN50x16",
                                  "RN50x64"])
def test_zoo_resnet_rows_match_jax(name):
    got, want = tzoo.get_arch(name), jzoo.get_arch(name)
    assert isinstance(got.vision, trn.ResNetVisionConfig)
    assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)
    assert got.vision.feat_dim == want.vision.feat_dim
    assert dataclasses.asdict(got.text) == dataclasses.asdict(want.text)


# ------------------------------------------------------------ fused steps

def _both_steps(model, jfused, tfused, jstate, tstate, seed=5):
    """Run the JAX fused step and the port's on the same canvases (JAX's
    view draws of `seed` handed to the port) under the bshd route; the
    results."""
    canv, hs, ws = _canvases(8)
    idxs = np.array([7, 2], np.int32)
    with jfa.force_mode("bshd"):
        want = jax.tree.map(np.asarray, jfused(
            model, *jstate, jnp.asarray(canv), jnp.asarray(hs),
            jnp.asarray(ws), jnp.asarray(idxs)))
    with tfa.force_mode("bshd"):
        got = tfused(params_from_numpy(model, "cpu"), *tstate,
                     torch.from_numpy(canv), torch.from_numpy(hs),
                     torch.from_numpy(ws),
                     stack_draws([jax_draws(jttl.sample_key(seed, int(i)), V)
                                  for i in idxs]))
    return got, want


def _text_cls(seed=9):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((len(CLASSES), 32))
    return (cls / np.linalg.norm(cls, axis=-1, keepdims=True)).astype(
        np.float32)


def test_fused_tpt_step_matches_jax(model):
    """`-a RN50 --lora_encoder prompt`'s step: the views through the ResNet
    tower, the prompt's ctx tuned through the text tower."""
    jcfg, cfg = _cfgs(lora_encoder="prompt", tta_steps=1)
    jstate = jprompts.init_prompt_learner(
        jnp.asarray(model["text"]["token_embed"]), CLASSES)
    got, want = _both_steps(
        model, jttl.make_fused_tpt_fn(J_CLIP_TINY, jcfg),
        tttl.make_fused_tpt_fn(CLIP_TINY, cfg), (jstate,),
        (prompt_learner_from_numpy(jstate, "cpu"),))
    (res, ctx), (jres, jctx) = got, want
    for name in ("logits", "zero_shot_logits", "losses"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   getattr(jres, name), **STEP,
                                   err_msg=name)
    np.testing.assert_allclose(ctx.numpy(), jctx, **STEP)
    assert np.abs(jctx - np.asarray(jstate.ctx_init)).max() > 1e-3


def test_fused_text_lora_step_matches_jax(model):
    jcfg, cfg = _cfgs(lora_encoder="text", tta_steps=1)
    tokens = np.asarray(jprompts.prompt_tokens(CLASSES))
    adapters0 = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 3, CLIP_TINY.text.hidden, RANK, "xavier"))
    # a trained-looking B, so that the adapters change the features
    for m in "qv":
        adapters0[m]["B"] = (np.random.default_rng(12).standard_normal(
            adapters0[m]["B"].shape) * 0.05).astype(np.float32)
    got, want = _both_steps(
        model, jttl.make_fused_ttl_fn(J_CLIP_TINY, jcfg,
                                      tokens=jnp.asarray(tokens)),
        tttl.make_fused_ttl_fn(CLIP_TINY, cfg, tokens=tokens),
        (jnp.asarray(_text_cls()), adapters0),
        (None, adapters_from_numpy(adapters0, "cpu")))
    np.testing.assert_allclose(got.logits.numpy(), want.logits, **STEP)
    np.testing.assert_allclose(got.losses.numpy(), want.losses, **STEP)


def test_fused_zeroshot_step_matches_jax(model):
    jcfg, cfg = _cfgs(tta_steps=0)
    cls = _text_cls()
    canv, hs, ws = _canvases(10)
    with jfa.force_mode("bshd"):
        want = np.asarray(jttl.make_fused_zeroshot_fn(J_CLIP_TINY, jcfg)(
                model, jnp.asarray(cls), jnp.asarray(canv), jnp.asarray(hs),
                jnp.asarray(ws), jnp.arange(len(SIZES))))
    got = tttl.make_fused_zeroshot_fn(CLIP_TINY, cfg)(
        params_from_numpy(model, "cpu"), torch.from_numpy(cls),
        torch.from_numpy(canv), torch.from_numpy(hs), torch.from_numpy(ws))
    assert got.shape == (len(SIZES), len(CLASSES))
    np.testing.assert_allclose(got.numpy(), want, **STEP)


def _live_cocoop(jstate):
    """The tiny meta-net has two hidden units; a bias of 0.5 keeps them
    live, so that the shift depends on the image (test_torch_cocoop.py)."""
    return dataclasses.replace(jstate,
                               meta_b1=jnp.full_like(jstate.meta_b1, 0.5))


def test_fused_cocoop_step_matches_jax(model):
    jcfg, cfg = _cfgs(cocoop=True, tta_steps=1)
    jstate = _live_cocoop(jco.init_cocoop(
        jnp.asarray(model["text"]["token_embed"]), CLASSES, 32,
        jax.random.PRNGKey(3), "a_photo_of_a"))
    got, want = _both_steps(
        model, jttl.make_fused_cocoop_fn(J_CLIP_TINY, jcfg),
        tttl.make_fused_cocoop_fn(CLIP_TINY, cfg), (jstate,),
        (cocoop_state_from_numpy(jstate, "cpu"),))
    for name in ("logits", "adapted_logits", "losses"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), **STEP,
                                   err_msg=name)


# ------------------------------------------------------------------ runner

@pytest.mark.parametrize("mode", [{"lora_encoder": "prompt"},
                                  {"tta_steps": 0}],
                         ids=["prompt", "zero-shot"])
def test_evaluate_dataset_matches_jax(model, monkeypatch, mode):
    """`runner.evaluate_dataset` on five images of CIFAR-10's classes with
    the tiny ResNet: the same top-1/top-5 as the JAX runner's, and each
    sample's logits within 5e-4 (JAX's view draws handed to the port)."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8)
    labels = np.array([3, 1, 4, 7, 5])
    kw = dict(arch="test-tiny", resolution=64, batch_size=V, sample_batch=2,
              compute_dtype="float32", param_dtype="float32", workers=1,
              selection_p=0.4, test_sets="cifar10", seed=3, **mode)
    seen = {"jax": [], "port": []}
    real_count = jeval.make_count_fn

    def recording_count(mesh=None):
        count = real_count(mesh)

        def record(logits, lab, valid):
            seen["jax"].append((np.asarray(logits), np.asarray(valid)))
            return count(logits, lab, valid)
        return record

    monkeypatch.setattr(jeval, "make_count_fn", recording_count)
    with jfa.force_mode("bshd"):
        want = jrunner.evaluate_dataset(
            "cifar10", JTTLConfig(**kw), J_CLIP_TINY, _jtree(model), None,
            dataset=JArrayDataset(images, labels))
    monkeypatch.setattr(trunner, "draw_batch",
                        lambda seed, indices, n: stack_draws(
                            [jax_draws(jttl.sample_key(seed, int(i)), n)
                             for i in indices]))
    real_topk = trunner.topk_counts

    def topk_and_record(logits, lab, valid):
        seen["port"].append((logits.numpy(), valid.numpy()))
        return real_topk(logits, lab, valid)

    monkeypatch.setattr(trunner, "topk_counts", topk_and_record)
    with tfa.force_mode("bshd"):
        got = trunner.evaluate_dataset(
            "cifar10", TTLConfig(**kw), CLIP_TINY,
            params_from_numpy(model, "cpu"), None, device="cpu",
            dataset=ArrayDataset(images, labels))
    assert got == pytest.approx(want, abs=1e-9)
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for (g, gv), (w, wv) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_allclose(g[gv], w[wv], **STEP)


@pytest.mark.parametrize("mode", [
    {"lora_encoder": "text", "filter_plpd": 1, "plpd_threshold": 0.0},
    {"lora_encoder": "prompt", "aug_ops": ("rotate", "equalize")},
    {"tta_steps": 0, "ensemble": True},
    {"tta_steps": 0, "lora_encoder": "prompt"},
    {"cocoop": True},
], ids=["text-plpd", "prompt-augmix", "zero-shot-ensemble",
        "zero-shot-prompt", "cocoop"])
def test_evaluate_dataset_runs_the_other_resnet_modes(model, mode):
    """The modes the JAX package allows on a ResNet tower beyond those held
    against it above, through `runner.evaluate_dataset` on two images:
    PLPD in text mode, AugMix views, the ensemble classifier, zero-shot on
    the prompt learner's own prompts, and CoCoOp."""
    images = np.random.default_rng(13).integers(0, 256, (2, 40, 56, 3),
                                                dtype=np.uint8)
    _, cfg = _cfgs(sample_batch=2, workers=1, **{"tta_steps": 1, **mode})
    with tfa.force_mode("bshd"):
        top1, top5 = trunner.evaluate_dataset(
            "cifar10", cfg, CLIP_TINY, params_from_numpy(model, "cpu"),
            trunner.make_adapters0(cfg, CLIP_TINY, "cpu"), device="cpu",
            dataset=ArrayDataset(images, np.array([3, 1])))
    assert 0.0 <= top1 <= top5 <= 100.0
