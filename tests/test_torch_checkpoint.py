"""Checkpoint loading of the port against `ttl_tpu.models.convert` and
`ttl_tpu.runner.load_model`, on the CPU.

No CLIP checkpoint is on disk, so the tests write their own: state dicts in
the HuggingFace `CLIPModel` and OpenAI `clip` layouts (ViT and ModifiedResNet
towers), filled from a seed at tiny sizes, or with zero-stride arrays at the
published ones where only shapes are read. Conversion is transposes,
slices, stacks and casts, so every comparison is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttl_tpu import runner as jrunner
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import convert as jconvert
from ttl_tpu.models import resnet as jrn
from ttl_tpu.models import zoo as jzoo
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import convert as tconvert
from ttl_tpu_torch.models import resnet as trn
from ttl_tpu_torch.models import zoo as tzoo

RN_TINY = tclip.CLIPConfig(
    vision=trn.ResNetVisionConfig(layers=(1, 2, 1, 1), width=16, heads=4,
                                  proj_dim=32, image_size=64),
    text=dataclasses.replace(tzoo.TEST_TINY.text, proj_dim=32))
J_RN_TINY = jclip.CLIPConfig(
    vision=jrn.ResNetVisionConfig(layers=(1, 2, 1, 1), width=16, heads=4,
                                  proj_dim=32, image_size=64),
    text=dataclasses.replace(jzoo.TEST_TINY.text, proj_dim=32))


# ----------------------------------------------------- synthetic state dicts

def _text_sd(t, fill, hf: bool) -> dict:
    h, m = t.hidden, t.hidden * t.mlp_ratio
    if hf:
        sd = {"text_model.embeddings.token_embedding.weight": (t.vocab, h),
              "text_model.embeddings.position_embedding.weight": (t.ctx, h),
              "text_model.final_layer_norm.weight": (h,),
              "text_model.final_layer_norm.bias": (h,),
              "text_projection.weight": (t.proj_dim, h)}
        for i in range(t.layers):
            sd.update(_hf_layer_shapes(f"text_model.encoder.layers.{i}", h, m))
    else:
        sd = {"token_embedding.weight": (t.vocab, h),
              "positional_embedding": (t.ctx, h), "ln_final.weight": (h,),
              "ln_final.bias": (h,), "text_projection": (h, t.proj_dim)}
        for i in range(t.layers):
            sd.update(_openai_layer_shapes(f"transformer.resblocks.{i}", h, m))
    return {k: fill(v) for k, v in sd.items()}


def _hf_layer_shapes(pre, h, m) -> dict:
    sd = {f"{pre}.layer_norm{i}.{p}": (h,) for i in (1, 2)
          for p in ("weight", "bias")}
    for n in ("q", "k", "v", "out"):
        sd[f"{pre}.self_attn.{n}_proj.weight"] = (h, h)
        sd[f"{pre}.self_attn.{n}_proj.bias"] = (h,)
    sd.update({f"{pre}.mlp.fc1.weight": (m, h), f"{pre}.mlp.fc1.bias": (m,),
               f"{pre}.mlp.fc2.weight": (h, m), f"{pre}.mlp.fc2.bias": (h,)})
    return sd


def _openai_layer_shapes(pre, h, m) -> dict:
    sd = {f"{pre}.ln_{i}.{p}": (h,) for i in (1, 2)
          for p in ("weight", "bias")}
    sd.update({f"{pre}.attn.in_proj_weight": (3 * h, h),
               f"{pre}.attn.in_proj_bias": (3 * h,),
               f"{pre}.attn.out_proj.weight": (h, h),
               f"{pre}.attn.out_proj.bias": (h,),
               f"{pre}.mlp.c_fc.weight": (m, h), f"{pre}.mlp.c_fc.bias": (m,),
               f"{pre}.mlp.c_proj.weight": (h, m),
               f"{pre}.mlp.c_proj.bias": (h,)})
    return sd


def _bn_shapes(pre, c) -> dict:
    return {f"{pre}.{p}": (c,) for p in ("weight", "bias", "running_mean",
                                         "running_var")}


def hf_state_dict(cfg, fill) -> dict:
    """An HF CLIPModel state dict of a ViT `cfg`, each tensor `fill(shape)`."""
    v = cfg.vision
    h, m = v.hidden, v.hidden * v.mlp_ratio
    sd = {"vision_model.embeddings.patch_embedding.weight":
          (h, 3, v.patch, v.patch),
          "vision_model.embeddings.class_embedding": (h,),
          "vision_model.embeddings.position_embedding.weight": (v.seq_len, h),
          "vision_model.pre_layrnorm.weight": (h,),
          "vision_model.pre_layrnorm.bias": (h,),
          "vision_model.post_layernorm.weight": (h,),
          "vision_model.post_layernorm.bias": (h,),
          "visual_projection.weight": (v.proj_dim, h), "logit_scale": ()}
    for i in range(v.layers):
        sd.update(_hf_layer_shapes(f"vision_model.encoder.layers.{i}", h, m))
    return {**{k: fill(s) for k, s in sd.items()},
            **_text_sd(cfg.text, fill, hf=True)}


def openai_state_dict(cfg, fill) -> dict:
    """An OpenAI clip state dict of `cfg` (ViT or ModifiedResNet), each
    tensor `fill(shape)`."""
    v = cfg.vision
    sd = {"logit_scale": ()}
    if isinstance(v, (trn.ResNetVisionConfig, jrn.ResNetVisionConfig)):
        w = v.width
        for i, (cin, cout) in enumerate([(3, w // 2), (w // 2, w // 2),
                                         (w // 2, w)], 1):
            sd[f"visual.conv{i}.weight"] = (cout, cin, 3, 3)
            sd.update(_bn_shapes(f"visual.bn{i}", cout))
        cin = w
        for stage in range(4):
            cmid = w * 2 ** stage
            for b in range(v.layers[stage]):
                pre = f"visual.layer{stage + 1}.{b}"
                for i, (ci, co, k) in enumerate([(cin, cmid, 1),
                                                 (cmid, cmid, 3),
                                                 (cmid, 4 * cmid, 1)], 1):
                    sd[f"{pre}.conv{i}.weight"] = (co, ci, k, k)
                    sd.update(_bn_shapes(f"{pre}.bn{i}", co))
                if b == 0:
                    sd[f"{pre}.downsample.0.weight"] = (4 * cmid, cin, 1, 1)
                    sd.update(_bn_shapes(f"{pre}.downsample.1", 4 * cmid))
                cin = 4 * cmid
        d = v.feat_dim
        sd["visual.attnpool.positional_embedding"] = (
            (v.image_size // 32) ** 2 + 1, d)
        for n, out in (("q", d), ("k", d), ("v", d), ("c", v.proj_dim)):
            sd[f"visual.attnpool.{n}_proj.weight"] = (out, d)
            sd[f"visual.attnpool.{n}_proj.bias"] = (out,)
    else:
        h, m = v.hidden, v.hidden * v.mlp_ratio
        sd.update({"visual.conv1.weight": (h, 3, v.patch, v.patch),
                   "visual.class_embedding": (h,),
                   "visual.positional_embedding": (v.seq_len, h),
                   "visual.ln_pre.weight": (h,), "visual.ln_pre.bias": (h,),
                   "visual.ln_post.weight": (h,), "visual.ln_post.bias": (h,),
                   "visual.proj": (h, v.proj_dim)})
        for i in range(v.layers):
            sd.update(_openai_layer_shapes(
                f"visual.transformer.resblocks.{i}", h, m))
    return {**{k: fill(s) for k, s in sd.items()},
            **_text_sd(cfg.text, fill, hf=False)}


def _seeded(seed=0):
    rng = np.random.default_rng(seed)
    return lambda shape: rng.standard_normal(shape).astype(np.float32)


def _zeros(shape):
    """A zero-stride array: shape only, no memory."""
    return np.broadcast_to(np.zeros((), np.float16), shape)


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))
        assert np.asarray(g).dtype == np.asarray(w).dtype


# --------------------------------------------------------------- converters

def test_from_hf_state_dict_matches_jax():
    sd = hf_state_dict(tzoo.TEST_TINY, _seeded())
    got = tconvert.from_hf_state_dict(sd, tzoo.TEST_TINY)
    _assert_trees_equal(got, jconvert.from_hf_state_dict(sd, jzoo.TEST_TINY))
    # the port's tensors: the layout init_clip_params gives, values as read
    tp = tconvert.params_from_numpy(got, "cpu")
    init = tclip.init_clip_params(tzoo.TEST_TINY,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    assert jax.tree.structure(jax.tree.map(np.shape, tp)) == \
        jax.tree.structure(jax.tree.map(np.shape, init))
    np.testing.assert_array_equal(
        tp["vision"]["layers"]["attn"]["q"]["w"][1].numpy(),
        sd["vision_model.encoder.layers.1.self_attn.q_proj.weight"].T)


@pytest.mark.parametrize("tower", ["vit", "resnet"])
def test_from_openai_state_dict_matches_jax(tower):
    cfg, jcfg = ((tzoo.TEST_TINY, jzoo.TEST_TINY) if tower == "vit"
                 else (RN_TINY, J_RN_TINY))
    sd = openai_state_dict(cfg, _seeded(1))
    got = tconvert.from_openai_state_dict(sd, cfg)
    _assert_trees_equal(got, jconvert.from_openai_state_dict(sd, jcfg))
    tp = tconvert.params_from_numpy(got, "cpu")
    text_q = sd["transformer.resblocks.2.attn.in_proj_weight"][:32].T
    np.testing.assert_array_equal(tp["text"]["layers"]["attn"]["q"]["w"][2],
                                  text_q)
    if tower == "resnet":
        # conv kernels OIHW as the file has them, the rest transposed
        np.testing.assert_array_equal(tp["vision"]["conv1"],
                                      sd["visual.conv1.weight"])
        np.testing.assert_array_equal(
            tp["vision"]["layer2"][1]["conv2"],
            sd["visual.layer2.1.conv2.weight"])
        np.testing.assert_array_equal(tp["vision"]["attnpool"]["out"]["w"],
                                      sd["visual.attnpool.c_proj.weight"].T)
        assert "downsample" not in tp["vision"]["layer2"][1]


@pytest.mark.parametrize("arch", ["RN50", "RN101", "ViT-B/16"])
def test_infer_config_from_openai_at_full_size(arch):
    """The published shapes, read from zero-stride arrays: the zoo's row,
    as the JAX package infers it."""
    sd = openai_state_dict(tzoo.get_arch(arch), _zeros)
    got, want = (tconvert.infer_config_from_openai(sd),
                 jconvert.infer_config_from_openai(sd))
    for part in ("vision", "text"):
        row = getattr(tzoo.get_arch(arch), part)
        assert type(getattr(got, part)) is type(row)
        assert dataclasses.asdict(getattr(got, part)) == \
            dataclasses.asdict(getattr(want, part)) == \
            dataclasses.asdict(getattr(jzoo.get_arch(arch), part)) == \
            dataclasses.asdict(row)


# ------------------------------------------------------------------- caches

@pytest.fixture(scope="module")
def rn_params():
    """JAX's tiny ResNet CLIP, numpy leaves (lists of blocks, HWIO)."""
    return jax.tree.map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_RN_TINY, param_dtype=jnp.float32))


def test_jax_cache_is_read_by_the_port(tmp_path, rn_params):
    path = str(tmp_path / "jax.npz")
    jconvert.save_pytree(path, rn_params)
    _assert_trees_equal(tconvert.load_pytree(path), rn_params)


def test_port_cache_is_read_by_jax(tmp_path, rn_params):
    """The port's tensors (OIHW) saved in the JAX layout, under keystr's
    keys, and read back by either package."""
    path = str(tmp_path / "port.npz")
    tconvert.save_pytree(path, tconvert.params_from_numpy(rn_params, "cpu"))
    with np.load(path) as flat:
        keys = set(flat.files)
    assert keys == {jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_leaves_with_path(rn_params)}
    assert "['vision']['layer2'][1]['conv2']" in keys
    _assert_trees_equal(jconvert.load_pytree(path), rn_params)
    _assert_trees_equal(tconvert.load_pytree(path), rn_params)


@pytest.mark.parametrize("kind", ["openai.pt", "wrapped.pt", "hf.bin",
                                  "cache.npz", "hf.safetensors"])
def test_load_checkpoint_matches_jax(tmp_path, kind):
    """Each format the loader takes, written once and read by both
    packages: fp16 tensors, as the published checkpoints hold them."""
    hf = kind.startswith("hf")
    cfg, jcfg = (tzoo.TEST_TINY, jzoo.TEST_TINY) if hf else (RN_TINY,
                                                             J_RN_TINY)
    sd = (hf_state_dict if hf else openai_state_dict)(cfg, _seeded(2))
    sd = {k: torch.from_numpy(v).half() for k, v in sd.items()}
    path = str(tmp_path / kind)
    if kind == "hf.safetensors":
        safetensors = pytest.importorskip("safetensors.torch")
        safetensors.save_file(sd, path)
    elif kind == "cache.npz":
        jconvert.save_pytree(path, jconvert.from_openai_state_dict(sd, jcfg))
    else:
        torch.save({"state_dict": sd} if kind == "wrapped.pt" else sd, path)
    got, got_cfg = tconvert.load_checkpoint(path, cfg)
    want, _ = jconvert.load_checkpoint(path, jcfg)
    assert got_cfg is cfg
    _assert_trees_equal(got, want)
    if kind == "openai.pt":
        # without a config, the one its shapes give (heads by the published
        # rule, width // 64)
        got, got_cfg = tconvert.load_checkpoint(path)
        want, want_cfg = jconvert.load_checkpoint(path)
        for part in ("vision", "text"):
            assert dataclasses.asdict(getattr(got_cfg, part)) == \
                dataclasses.asdict(getattr(want_cfg, part))
        _assert_trees_equal(got, want)


@pytest.mark.parametrize("kind", ["openai-resnet", "hf-vit"])
def test_runner_load_model_matches_jax(tmp_path, monkeypatch, kind):
    """`--checkpoint_path` at param_dtype bfloat16: leaves of two or more
    axes bf16, the rest f32, values as `ttl_tpu.runner.load_model`'s."""
    if kind == "hf-vit":
        arch, cfg, sd = "test-tiny", tzoo.TEST_TINY, hf_state_dict(
            tzoo.TEST_TINY, _seeded(3))
    else:
        # the tiny ResNet is no arch name: both runners take it for one
        arch, cfg, sd = "RN50", RN_TINY, openai_state_dict(RN_TINY,
                                                           _seeded(3))
        monkeypatch.setattr(trunner, "get_arch", lambda name: RN_TINY)
        monkeypatch.setattr(jrunner, "get_arch", lambda name: J_RN_TINY)
    path = str(tmp_path / "clip.pt")
    torch.save({k: torch.from_numpy(v).half() for k, v in sd.items()}, path)
    kw = dict(arch=arch, checkpoint_path=path, param_dtype="bfloat16")
    got_cfg, got = trunner.load_model(TTLConfig(**kw), "cpu")
    _, want = jrunner.load_model(JTTLConfig(**kw))
    assert got_cfg is cfg
    got_np = tconvert.params_to_numpy(got)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for (path_, w), g, t in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree.leaves(got_np), jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path_)
        assert t.dtype == (torch.bfloat16 if w.ndim >= 2
                           else torch.float32), name
        assert str(w.dtype) == str(t.dtype).split(".")[-1], name
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=name)
