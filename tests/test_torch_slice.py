"""The port's main path as a whole, on the CPU.

- The fused step, from uint8 canvases to adapted logits, against the JAX
  package's `make_fused_ttl_fn` on the same weights, given JAX's own view
  draws (pulled from the same key splits): within 5e-4, the bound of
  tests/test_composite_oracle.py.
- The zero-shot step (center view, `--tta_steps 0`) against
  `make_fused_zeroshot_fn`, with the fp tower (1e-4, as the towers) and with
  the whole tower int8 and its fp stack dropped (top-1, and a bound argued
  as in tests/test_torch_adapt.py).
- `ttl_tpu_torch.runner.run` end to end on a tiny synthetic dataset, in the
  default mode, with `--prefix_quant int8`, and zero-shot with the int8
  tower and the ensemble classifier.
- The port's runtime imports no JAX; its CLI refuses to run without CUDA and
  raises on flags it does not cover yet (`--filter_plpd` and `--aug_list`
  are covered now: tests/test_torch_plpd.py, tests/test_torch_augmix.py;
  the ResNet archs and `--checkpoint_path`: tests/test_torch_resnet.py,
  tests/test_torch_checkpoint.py; the bongard set:
  tests/test_torch_bongard.py, and here one run from the parsed flags).
  Image-LoRA on a ResNet arch raises the JAX package's ValueError; a
  missing checkpoint, FileNotFoundError.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_threads
from test_torch_image import jax_draws, stack_draws

from ttl_tpu.adapt.ttl import make_fused_ttl_fn as j_make_fused
from ttl_tpu.adapt.ttl import make_fused_zeroshot_fn as j_make_zeroshot
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig
from ttl_tpu import runner as jrunner
from ttl_tpu.data.views import ArrayDataset
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models import zoo as jzoo
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops import quant as jq
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt.ttl import make_fused_ttl_fn, make_fused_zeroshot_fn
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.data.views import ArrayDataset as TArrayDataset
from ttl_tpu_torch.models import zoo as tzoo
from ttl_tpu_torch.models.zoo import TEST_TINY

V, RANK, N_CLS, CANVAS = 8, 4, 6, 80
SIZES = [(80, 80), (50, 72), (64, 30)]   # full canvas, wide, tall


def test_fused_slice_matches_jax():
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                    layer_range=(2, 3), rank=RANK, seed=5, tta_steps=1,
                    compute_dtype="float32", param_dtype="float32")
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    adapters0 = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.vision.hidden, RANK, "xavier"))
    rng = np.random.default_rng(3)
    text_cls = rng.standard_normal((N_CLS, J_TINY.vision.proj_dim))
    text_cls = (text_cls / np.linalg.norm(text_cls, axis=-1, keepdims=True)
                ).astype(np.float32)
    canv = np.zeros((len(SIZES), CANVAS, CANVAS, 3), np.uint8)
    for i, (h, w) in enumerate(SIZES):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hs = np.array([h for h, _ in SIZES], np.int32)
    ws = np.array([w for _, w in SIZES], np.int32)
    idxs = np.array([11, 4, 27], np.int32)

    with jfa.force_mode("bshd"):
        fn = j_make_fused(J_TINY, cfg)
        want = np.asarray(fn(params, jnp.asarray(text_cls), adapters0,
                             jnp.asarray(canv), jnp.asarray(hs),
                             jnp.asarray(ws), jnp.asarray(idxs)).logits)

    draws = stack_draws([jax_draws(sample_key(cfg.seed, int(i)), V)
                         for i in idxs])
    got = make_fused_ttl_fn(TEST_TINY, cfg)(
        params_from_numpy(params, "cpu"), torch.from_numpy(text_cls),
        adapters_from_numpy(adapters0, "cpu"), torch.from_numpy(canv),
        torch.from_numpy(hs), torch.from_numpy(ws), draws)
    assert got.logits.shape == (len(SIZES), N_CLS)
    np.testing.assert_allclose(got.logits.numpy(), want, rtol=5e-4,
                               atol=5e-4)


def test_zeroshot_step_matches_jax():
    """fp tower, then the whole tower int8 with the fp stack dropped."""
    cfg = TTLConfig(arch="test-tiny", resolution=64, tta_steps=0,
                    compute_dtype="float32", param_dtype="float32")
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    qparams = jax.tree.map(np.asarray, jq.attach_prefix_quant(
        params, jq.quant_prefix_len(cfg, J_TINY), drop_fp=True))
    assert qparams["vision"]["layers"]["ln1"]["scale"].shape[0] == 0
    rng = np.random.default_rng(6)
    text_cls = rng.standard_normal((N_CLS, J_TINY.vision.proj_dim))
    text_cls = (text_cls / np.linalg.norm(text_cls, axis=-1, keepdims=True)
                ).astype(np.float32)
    canv = np.zeros((len(SIZES), CANVAS, CANVAS, 3), np.uint8)
    for i, (h, w) in enumerate(SIZES):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hs = np.array([h for h, _ in SIZES], np.int32)
    ws = np.array([w for _, w in SIZES], np.int32)

    def jax_logits(p):
        with jfa.force_mode("bshd"):
            return np.asarray(j_make_zeroshot(J_TINY, cfg)(
                p, jnp.asarray(text_cls), jnp.asarray(canv), jnp.asarray(hs),
                jnp.asarray(ws), jnp.arange(len(SIZES))))

    def port_logits(p):
        return make_fused_zeroshot_fn(TEST_TINY, cfg)(
            params_from_numpy(p, "cpu"), torch.from_numpy(text_cls),
            torch.from_numpy(canv), torch.from_numpy(hs),
            torch.from_numpy(ws)).numpy()

    want_fp, want_q = jax_logits(params), jax_logits(qparams)
    got_fp, got_q = port_logits(params), port_logits(qparams)
    assert got_q.shape == (len(SIZES), N_CLS)
    np.testing.assert_allclose(got_fp, want_fp, rtol=1e-4, atol=1e-4)
    effect = np.abs(want_q - want_fp).max()
    bound = 1e-4 + 0.25 * effect
    assert effect > bound
    np.testing.assert_array_equal(got_q.argmax(-1), want_q.argmax(-1))
    assert np.abs(got_q - want_q).max() <= bound


def _run_end_to_end(tmp_path, capsys, **mode):
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8),
                      np.array([3, 1, 4, 1, 5]))
    out = tmp_path / "results.json"
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                    sample_batch=2, compute_dtype="float32",
                    param_dtype="float32", print_freq=1, workers=1,
                    results_json=str(out), **mode)
    res = trunner.run(cfg, device="cpu", datasets={"A": ds})
    top1, top5 = res["A"]
    assert 0.0 <= top1 <= top5 <= 100.0
    text = capsys.readouterr().out
    assert "======== Result Summary ========" in text
    assert "=> Acc. on testset [A]" in text
    assert json.loads(out.read_text())["results"]["A"]["top5"] == round(
        top5, 4)


def test_runner_end_to_end_on_cpu(tmp_path, capsys):
    _run_end_to_end(tmp_path, capsys)


@pytest.mark.parametrize("mode", [
    {"prefix_quant": "int8"},
    {"prefix_quant": "int8", "tta_steps": 0, "ensemble": True}])
def test_runner_end_to_end_int8_and_zero_shot(tmp_path, capsys, mode):
    _run_end_to_end(tmp_path, capsys, **mode)


def test_runtime_imports_no_jax():
    code = ("import sys, ttl_tpu_torch, ttl_tpu_torch.runner, "
            "ttl_tpu_torch.cli, ttl_tpu_torch.ops.quant, "
            "ttl_tpu_torch.adapt.ttl, ttl_tpu_torch.models.prompts, "
            "ttl_tpu_torch.adapt.cocoop, ttl_tpu_torch.ops.ln_matmul, "
            "ttl_tpu_torch.ops.augmix, "
            "ttl_tpu_torch.utils.checkpoint; "
            "assert 'jax' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith('jax'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=test_torch_threads.subprocess_env())
    assert proc.returncode == 0, proc.stderr


def test_cli_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["data", "--test_sets", "A"])


@pytest.mark.parametrize("flags", [
    ["--mesh_shape", "2"],
])
def test_uncovered_flags_raise(flags):
    args = tcli.build_parser().parse_args(["data", *flags])
    cfg = tcli.config_from_args(args)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.run(cfg, device="cpu", datasets={})


def test_cli_parsed_bongard_set_runs(tmp_path, capsys):
    """`--test_sets bongard` (tests/test_torch_bongard.py holds it against
    the JAX package): one episode of six support images a polarity and a
    query each, through `runner.run` from the parsed flags."""
    from PIL import Image
    from ttl_tpu_torch.data.bongard import BongardDataset
    rng = np.random.default_rng(0)
    task = [[], [], "hold++cup"]
    for polarity, hue in ((0, 2), (1, 0)):   # neg, pos
        for i in range(7):
            img = rng.integers(0, 80, (40 + 4 * i, 48, 3), dtype=np.uint8)
            img[..., hue] += 160
            Image.fromarray(img).save(tmp_path / f"{polarity}_{i}.png")
            task[polarity].append({"im_path": f"./{polarity}_{i}.png"})
    (tmp_path / "bongard_hoi_test_unseen_obj_unseen_act.json").write_text(
        json.dumps([task]))
    args = tcli.build_parser().parse_args([
        str(tmp_path), "--test_sets", "bongard", "-a", "test-tiny",
        "--resolution", "64", "-b", "8", "--layer_range", "2,3", "--rank",
        "4", "--compute_dtype", "float32", "--param_dtype", "float32"])
    cfg = tcli.config_from_args(args)
    ds = BongardDataset(cfg.data, splits_dir=str(tmp_path))
    acc, top5 = trunner.run(cfg, device="cpu",
                            datasets={"bongard": ds})["bongard"]
    assert acc in (0.0, 50.0, 100.0) and top5 == 100.0
    assert "=> Acc. on testset [bongard]" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["RN50", "RN101"])
def test_image_lora_on_a_resnet_arch_raises_jax_value_error(arch):
    """`-a RN50 --lora_encoder image` (the default mode): no adapters for
    the tower, and evaluate_dataset raises the JAX package's ValueError on
    a tiny dataset, before it reads any weight."""
    args = tcli.build_parser().parse_args(["data", "-a", arch])
    cfg = tcli.config_from_args(args)
    images = np.zeros((2, 40, 56, 3), np.uint8)
    labels = np.array([3, 1])
    assert trunner.make_adapters0(cfg, tzoo.get_arch(arch), "cpu") is None
    with pytest.raises(ValueError, match="ResNet vision tower") as got:
        trunner.evaluate_dataset("A", cfg, tzoo.get_arch(arch), None, None,
                                 device="cpu",
                                 dataset=TArrayDataset(images, labels))
    with pytest.raises(ValueError) as want:
        jrunner.evaluate_dataset("A", TTLConfig(**dataclasses.asdict(cfg)),
                                 jzoo.get_arch(arch), None, None,
                                 dataset=ArrayDataset(images, labels))
    assert str(got.value) == str(want.value)


def test_missing_checkpoint_raises_file_not_found(tmp_path):
    path = str(tmp_path / "clip.pt")
    args = tcli.build_parser().parse_args(["data", "--checkpoint_path",
                                           path])
    with pytest.raises(FileNotFoundError, match="clip.pt"):
        trunner.run(tcli.config_from_args(args), device="cpu", datasets={})


def test_prefix_quant_other_than_int8_raises_value_error():
    cfg = TTLConfig(arch="test-tiny", prefix_quant="int4")
    with pytest.raises(ValueError, match="int4"):
        trunner.run(cfg, device="cpu", datasets={})


@pytest.mark.parametrize("mode", [{"cocoop": True},
                                  {"lora_encoder": "text"}])
def test_ensemble_outside_image_lora_raises_value_error(mode):
    cfg = TTLConfig(arch="test-tiny", ensemble=True, **mode)
    with pytest.raises(ValueError, match="--ensemble"):
        trunner.evaluate_dataset("A", cfg, None, None, None, device="cpu")
