"""The port's tools (`tools/torch_*.py`, the counterparts of
tools/convert_checkpoint.py, tools/quant_fidelity.py,
examples/toy_ttl_demo.py and tools/parity_all.py) on the CPU.

- `torch_convert_checkpoint`: a synthetic OpenAI-layout `.pt` of JAX's tiny
  weights becomes an `.npz` whose every leaf equals, bit for bit, the
  checkpoint's as `load_checkpoint` reads it and the JAX package's own
  converter writes it.
- `torch_quant_fidelity --cpu` at test-tiny prints the JAX tool's keys.
- `torch_toy_ttl_demo --cpu` at a few training steps: the adapted logits'
  mean max-probability is above the zero-shot logits'.
- `torch_parity_all --cpu` over a synthetic ImageNet-A tree, as
  tests/test_parity_harness.py drives tools/parity_all.py: the rows run
  green with no pinned expectation, the coop row skips with its reason, a
  wrong expectation fails the run with exit code 1, and no checkpoint at
  all exits asking for one.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_threads
from oracle_utils import export_openai_vit_sd
from ttl_tpu.models import convert as jconvert
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu_torch.models.convert import load_checkpoint, load_pytree
from ttl_tpu_torch.models.zoo import TEST_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--resolution", "64", "-b", "8", "--layer_range", "2,3", "--rank",
        "4", "--compute_dtype", "float32", "--param_dtype", "float32",
        "--sample_batch", "4"]


def load_tool(name: str):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    params = init_clip_params(jax.random.PRNGKey(42), J_TINY)
    sd = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
          export_openai_vit_sd(params, J_TINY.vision).items()}
    torch.save(sd, str(tmp / "tiny_clip.pt"))
    return tmp / "tiny_clip.pt"


def test_convert_round_trip_is_bit_for_bit(tiny_pt, tmp_path, capsys):
    out = tmp_path / "tiny.npz"
    load_tool("torch_convert_checkpoint").main(
        [str(tiny_pt), "--arch", "test-tiny", "--out", str(out)])
    assert f"wrote {out}:" in capsys.readouterr().out
    got = dict(leaves(load_pytree(str(out))))
    want = dict(leaves(load_checkpoint(str(tiny_pt), TEST_TINY)[0]))
    j_tree, _ = jconvert.load_checkpoint(str(tiny_pt), J_TINY)
    jconvert.save_pytree(str(tmp_path / "jax.npz"), j_tree)
    from_jax = dict(leaves(jconvert.load_pytree(str(tmp_path / "jax.npz"))))
    assert got.keys() == want.keys() == from_jax.keys()
    for key in got:
        for other in (want, from_jax):
            assert got[key].dtype == other[key].dtype, key
            np.testing.assert_array_equal(got[key], other[key], err_msg=key)


def test_quant_fidelity_prints_the_jax_tools_keys(capsys):
    out = load_tool("torch_quant_fidelity").main(
        ["--cpu", "--arch", "test-tiny", "--samples", "4",
         "--sample_batch", "2", "--classes", "10"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert {"metric", "samples", "top1_flip_rate", "top5_overlap_of_5",
            "logit_max_abs_dev", "logit_mean_abs_dev"} <= line.keys()
    assert line["samples"] == 4 and line["device"] == "cpu"
    assert 0 <= line["top1_flip_rate"] <= 1
    assert 0 <= line["top5_overlap_of_5"] <= 5
    # the int8 prefix moves the logits, but not by much
    assert 0 < line["logit_max_abs_dev"] < 1


def test_toy_demo_raises_the_mean_max_probability(capsys):
    res = load_tool("torch_toy_ttl_demo").main(["--cpu", "--train_steps",
                                                "20"])
    assert res["ttl"][1] > res["zero_shot"][1]
    assert "zero-shot : top-1" in capsys.readouterr().out


@pytest.fixture(scope="module")
def imagenet_a_tree(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("data")
    d = root / "imagenet-adversarial" / "imagenet-a"
    rng = np.random.RandomState(0)
    for wnid in ("n01498041", "n01531178", "n01534433"):
        (d / wnid).mkdir(parents=True)
        for i in range(3):
            arr = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / wnid / f"img_{i}.jpg")
    return str(root)


def test_parity_runbook_over_a_synthetic_tree(imagenet_a_tree, tiny_pt,
                                              tmp_path):
    env = {**test_torch_threads.subprocess_env(), "PYTHONPATH": REPO}

    def runbook(*argv):
        return subprocess.run(
            [sys.executable, "tools/torch_parity_all.py", imagenet_a_tree,
             "--test_sets", "A", "--arch", "test-tiny", "--cpu", *argv,
             "--out", str(tmp_path / "res.json"), "--extra", *TINY],
            capture_output=True, text=True, timeout=600, env=env, cwd=REPO)

    npz = tmp_path / "tiny.npz"
    load_tool("torch_convert_checkpoint").main(
        [str(tiny_pt), "--arch", "test-tiny", "--out", str(npz)])
    exp = tmp_path / "exp.json"
    exp.write_text("{}")
    r = runbook("--rows", "zero-shot,ttl,coop", "--npz", str(npz),
                "--expected_json", str(exp))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    res = json.loads((tmp_path / "res.json").read_text())
    assert res["pass"] is True
    assert res["rows"]["zero-shot"]["sets"]["A"]["top1"] >= 0
    assert res["rows"]["ttl"]["sets"]["A"]["top1"] >= 0
    assert "needs --coop_ckpt" in res["rows"]["coop"]["skipped"]
    assert "-c" in res["rows"]["ttl"]["cmd"].split()

    # a wrong expectation at the 0.3 tolerance fails the run
    exp.write_text(json.dumps({"zero-shot": {"A": 150.0}}))
    r = runbook("--rows", "zero-shot", "--npz", str(npz),
                "--expected_json", str(exp))
    assert r.returncode == 1, (r.stdout[-2000:], r.stderr[-2000:])
    res = json.loads((tmp_path / "res.json").read_text())
    assert res["pass"] is False
    assert res["rows"]["zero-shot"]["sets"]["A"]["ok"] is False
    assert res["rows"]["zero-shot"]["sets"]["A"]["expected"] == 150.0

    # no download: without a checkpoint it asks for one
    r = runbook("--rows", "zero-shot")
    assert r.returncode != 0 and "pass --ckpt" in r.stderr
