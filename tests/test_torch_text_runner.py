"""`runner.run` end to end on the CPU in the text-side modes (text-LoRA,
TPT prompt tuning, the TPT objective on LoRA, prompt-mode zero-shot) under
each attention route, the route switch's error, a `--load` path with no
file, and the adapters' width in text mode. The steps of these modes are
held against the JAX package in tests/test_torch_text.py; these cases were
split from that file so that it no longer sets the suite's longest file.
"""
import dataclasses

import numpy as np
import pytest
import test_torch_threads  # noqa: F401  (torch threads per worker)

from ttl_tpu.config import TTLConfig
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops import attention as tfa

V, RANK = 8, 4


@pytest.mark.parametrize("route", ["bshd", "per_head", "heads", ""])
@pytest.mark.parametrize("mode", [
    {"lora_encoder": "text"}, {"lora_encoder": "prompt"},
    {"deyo_selection": False},
    {"lora_encoder": "text", "deyo_selection": False},
    {"lora_encoder": "prompt", "tta_steps": 0}], ids=str)
def test_runner_new_modes_end_to_end(route, mode):
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8),
                      np.array([3, 1, 4]))
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                    sample_batch=2, compute_dtype="float32",
                    param_dtype="float32", workers=1, **mode)
    with tfa.force_mode(route):
        top1, top5 = trunner.run(cfg, device="cpu", datasets={"A": ds})["A"]
    assert 0.0 <= top1 <= top5 <= 100.0


def test_runner_raises_on_unknown_route(monkeypatch):
    monkeypatch.setenv("TTL_FUSED_ATTENTION", "flash")
    tfa.reset_mode()
    try:
        with pytest.raises(ValueError, match="TTL_FUSED_ATTENTION"):
            trunner.run(TTLConfig(arch="test-tiny"), device="cpu",
                        datasets={})
    finally:
        monkeypatch.delenv("TTL_FUSED_ATTENTION")
        tfa.reset_mode()


def test_prompt_checkpoint_is_not_ported(tmp_path, capsys):
    """It was not, and raised; now `--lora_encoder prompt --load FILE` reads
    the file (tests/test_torch_cocoop.py holds the loaded run against the
    JAX runner). Here: a path with no file behind it prints the reference's
    line and the run goes on with the prompt learner's own ctx."""
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
                      np.array([3, 1]))
    kw = dict(arch="test-tiny", resolution=64, batch_size=V, sample_batch=2,
              compute_dtype="float32", param_dtype="float32", workers=1,
              lora_encoder="prompt")
    want = trunner.run(TTLConfig(**kw), device="cpu", datasets={"A": ds})
    capsys.readouterr()
    missing = str(tmp_path / "ctx.pth")
    got = trunner.run(TTLConfig(load=missing, **kw), device="cpu",
                      datasets={"A": ds})
    assert got == want
    assert f"=> no checkpoint found at '{missing}'" in capsys.readouterr().out


def test_text_mode_adapters_take_the_text_width():
    clip_cfg = dataclasses.replace(
        TEST_TINY, text=dataclasses.replace(TEST_TINY.text, hidden=48))
    ad = trunner.make_adapters0(TTLConfig(lora_encoder="text", rank=RANK),
                                clip_cfg, "cpu")
    assert ad["q"]["A"].shape == (3, 48, RANK)
    ad = trunner.make_adapters0(TTLConfig(rank=RANK), clip_cfg, "cpu")
    assert ad["q"]["A"].shape == (3, TEST_TINY.vision.hidden, RANK)
