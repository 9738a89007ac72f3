"""Batch prediction (`ttl_tpu_torch.predict`) against `ttl_tpu.predict`, on
the CPU.

Same directory of images (written from a numpy seed) on both sides, JAX's
weights and adapters bridged across, and JAX's view draws of each dataset
index handed to the port's `runner.draw_batch`; everything in f32 at the
`test-tiny` size. Tolerance: 1e-5 relative at f32 (plus 1e-6 absolute, the
rounding of a probability to 6 places in the output).

- `predict_directory`'s JSON lines, adapted (with the zero-shot aux pass)
  and at `--tta_steps 0`: equal paths, labels, top-k labels and
  `zero_shot_label`, probabilities within the tolerance.
- An empty directory raises FileNotFoundError; prompt mode and image-LoRA
  on a ResNet tower raise the JAX package's ValueErrors; `main` raises
  without CUDA.
"""
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
import test_torch_threads  # noqa: F401  (torch threads per worker)
from test_torch_image import jax_draws, stack_draws

from ttl_tpu import predict as jpredict
from ttl_tpu import runner as jrunner
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu_torch import predict as tpredict
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY

RTOL, ATOL = 1e-5, 1e-6
KW = dict(arch="test-tiny", resolution=64, batch_size=8, layer_range=(2, 3),
          rank=4, compute_dtype="float32", param_dtype="float32",
          sample_batch=2, workers=1)
CLASSES = ["forest", "river", "highway"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Five JPEG and PNG images of mixed sizes, two in a subdirectory, as
    tests/test_predict.py makes them."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    (root / "sub").mkdir()
    for i in range(5):
        arr = (rng.rand(70 + 5 * i, 90, 3) * 255).astype(np.uint8)
        where = root / "sub" if i % 2 else root
        Image.fromarray(arr).save(where / f"img_{i}.{('jpg', 'png')[i > 2]}")
    return str(root)


@pytest.fixture(scope="module")
def model():
    """JAX's weights and adapters (its runner's own) as numpy trees."""
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    adapters0 = jax.tree.map(np.array, jrunner.make_adapters0(
        JTTLConfig(**KW), J_TINY))
    return params, adapters0


def _predict_both(monkeypatch, model, cfg_kw, topk=3):
    """Both packages' predict_directory on the same directory, weights,
    adapters and view draws: (port lines, JAX lines)."""
    params, adapters0 = model
    monkeypatch.setattr(jrunner, "load_model", lambda c: (J_TINY, params))
    monkeypatch.setattr(trunner, "load_model", lambda c, device: (
        TEST_TINY, params_from_numpy(params, device)))
    monkeypatch.setattr(trunner, "make_adapters0", lambda c, clip, device:
                        adapters_from_numpy(adapters0, device))
    monkeypatch.setattr(
        trunner, "draw_batch",
        lambda seed, indices, n: stack_draws(
            [jax_draws(sample_key(seed, int(i)), n) for i in indices]))
    sinks = io.StringIO(), io.StringIO()
    n = tpredict.predict_directory(TTLConfig(**KW, **cfg_kw), CLASSES,
                                   device="cpu", topk=topk, out=sinks[0])
    with jfa.force_mode("bshd"):
        n_ref = jpredict.predict_directory(JTTLConfig(**KW, **cfg_kw),
                                           CLASSES, topk=topk, out=sinks[1])
    assert n == n_ref
    return [[json.loads(ln) for ln in s.getvalue().splitlines()]
            for s in sinks]


@pytest.mark.parametrize("tta_steps", [1, 0])
def test_predict_directory_matches_jax(monkeypatch, model, image_dir,
                                       tta_steps):
    got, want = _predict_both(monkeypatch, model,
                              {"data": image_dir, "tta_steps": tta_steps})
    assert len(got) == len(want) == 5
    assert [r["path"] for r in got] == tpredict.ImageDirDataset(
        image_dir).paths
    for g, w in zip(got, want):
        assert set(g) == {"path", "label", "topk", "zero_shot_label"}
        for key in ("path", "label", "zero_shot_label"):
            assert g[key] == w[key]
        assert [t["label"] for t in g["topk"]] == \
            [t["label"] for t in w["topk"]]
        np.testing.assert_allclose([t["prob"] for t in g["topk"]],
                                   [t["prob"] for t in w["topk"]],
                                   rtol=RTOL, atol=ATOL)
        probs = [t["prob"] for t in g["topk"]]
        assert probs == sorted(probs, reverse=True)
        assert abs(sum(probs) - 1.0) < 1e-5  # topk == all 3 classes
        if tta_steps == 0:
            assert g["label"] == g["zero_shot_label"]  # no adaptation


def test_empty_directory_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no images"):
        tpredict.ImageDirDataset(str(tmp_path))


@pytest.mark.parametrize("mode,match", [
    ({"arch": "RN50"}, "ResNet vision tower"),
    ({"lora_encoder": "prompt"}, "LoRA modes")])
def test_predict_validates_modes(image_dir, mode, match):
    """The JAX package's ValueErrors, raised before any weight is made."""
    cfg = dataclasses.replace(TTLConfig(**KW), data=image_dir, **mode)
    with pytest.raises(ValueError, match=match):
        tpredict.predict_directory(cfg, CLASSES, device="cpu")


def test_main_refuses_to_run_without_cuda(monkeypatch, image_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpredict.main([image_dir, "--test_sets", "eurosat"])


def test_parser_has_the_jax_flags_and_gpu(monkeypatch):
    """The JAX package's flags and defaults (its parser is built inside its
    main), and --gpu."""
    import argparse

    def table(parser):
        return {a.dest: (a.default, a.choices) for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    def capture(parser, *a, **k):
        raise SystemExit(table(parser))

    got = table(tpredict.build_parser())
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit) as want:
        jpredict.main(["x"])
    assert got.pop("gpu") == (0, None)
    assert got == want.value.code
