"""The port's main path as a whole, on the CPU.

- The fused step, from uint8 canvases to adapted logits, against the JAX
  package's `make_fused_ttl_fn` on the same weights, given JAX's own view
  draws (pulled from the same key splits): within 5e-4, the bound of
  tests/test_composite_oracle.py.
- `ttl_tpu_torch.runner.run` end to end on a tiny synthetic dataset.
- The port's runtime imports no JAX; its CLI refuses to run without CUDA and
  raises on flags it does not cover yet.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_image import jax_draws, stack_draws

from ttl_tpu.adapt.ttl import make_fused_ttl_fn as j_make_fused
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig
from ttl_tpu.data.views import ArrayDataset
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt.ttl import make_fused_ttl_fn
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
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


def test_runner_end_to_end_on_cpu(tmp_path, capsys):
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8),
                      np.array([3, 1, 4, 1, 5]))
    out = tmp_path / "results.json"
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                    sample_batch=2, compute_dtype="float32",
                    param_dtype="float32", print_freq=1, workers=1,
                    results_json=str(out))
    res = trunner.run(cfg, device="cpu", datasets={"A": ds})
    top1, top5 = res["A"]
    assert 0.0 <= top1 <= top5 <= 100.0
    text = capsys.readouterr().out
    assert "======== Result Summary ========" in text
    assert "=> Acc. on testset [A]" in text
    assert json.loads(out.read_text())["results"]["A"]["top5"] == round(
        top5, 4)


def test_runtime_imports_no_jax():
    code = ("import sys, ttl_tpu_torch, ttl_tpu_torch.runner, "
            "ttl_tpu_torch.cli; assert 'jax' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith('jax'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cli_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["data", "--test_sets", "A"])


@pytest.mark.parametrize("flags", [
    ["--lora_encoder", "text"], ["--cocoop"], ["--tta_steps", "0"],
    ["--filter_plpd", "1"], ["--prefix_quant", "int8"], ["-a", "RN50"],
])
def test_uncovered_flags_raise(flags):
    args = tcli.build_parser().parse_args(["data", *flags])
    cfg = tcli.config_from_args(args)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.run(cfg, device="cpu", datasets={})
