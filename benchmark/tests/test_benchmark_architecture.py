"""A configuration names its architecture, and the harness finds that
architecture's reference (`reference/arch/<name>.py`) and operation counts
(`work/<name>.py`) by the name; the program's counters are files of their
own (`counters/<name>.json`) and reach the traced offline run."""
from __future__ import annotations

import copy
import time
import types

import pytest
import torch

from conftest import run_cpu, tiny_cell

from benchmark.harness import counters, images, manifest, session, work
from benchmark.harness.manifest import metric_reader
from benchmark.harness.program import classnames
from benchmark.reference import run as reference

TOY_ARCH = '''
import numpy as np
import torch

IMAGE_MEAN = (0.5, 0.5, 0.5)
IMAGE_STD = (0.25, 0.25, 0.25)


def draw_weights(config, seed):
    g = torch.Generator().manual_seed(seed)
    v, t, p = config["vision"], config["text"], config["projection_dim"]
    d = v["hidden_size"]
    return {"vision": {
                "patch": torch.randn(3 * v["patch_size"] ** 2, d,
                                     generator=g) * 0.05,
                "layers": torch.randn(v["num_hidden_layers"], d, d,
                                      generator=g) * 0.2,
                "proj": torch.randn(d, p, generator=g) * 0.2},
            "text": {"embed": torch.randn(16, p, generator=g)},
            "logit_scale": torch.tensor(3.0)}


def draw_adapters(config, seed):
    lo, hi = config["ttl"]["lora_layers"]
    d, r = config["vision"]["hidden_size"], config["ttl"]["lora_rank"]
    g = torch.Generator().manual_seed(seed)
    return {"q": {"A": torch.randn(hi - lo + 1, d, r, generator=g) * 0.1,
                  "B": torch.zeros(hi - lo + 1, r, d)}}


def vision_prefix(p, images, vcfg, upto, *, mm):
    b, pt = images.shape[0], vcfg["patch_size"]
    g = vcfg["image_size"] // pt
    x = images.reshape(b, 3, g, pt, g, pt).permute(0, 2, 4, 1, 3, 5)
    x = mm(x.reshape(b, g * g, -1), p["patch"])
    for i in range(upto):
        x = x + torch.tanh(mm(x, p["layers"][i]))
    return x


def vision_rest(p, x, vcfg, lo, adapters=None, hi=None, scale=2.0, n=1, *,
                mm):
    for i in range(lo, vcfg["num_hidden_layers"]):
        h = mm(x, p["layers"][i])
        if adapters is not None and i <= hi:
            a, b = adapters["q"]["A"][:, i - lo], adapters["q"]["B"][:, i - lo]
            xx = x.reshape(n, -1, x.shape[-1])
            h = h + (scale * (xx @ a) @ b).reshape(x.shape)
        x = x + torch.tanh(h)
    return mm(x.mean(dim=1), p["proj"])


def text_classifier(p, tokens, tcfg, *, mm):
    return p["embed"][tokens].mean(dim=1)


def prompt_table(classnames, template):
    return np.array([[i % 16, (7 * i) % 16] for i in range(len(classnames))],
                    np.int64)
'''

TOY_WORK = '''
def layer_flops(config):
    return 2.0 * config["vision"]["hidden_size"] ** 2


def image_flops(config):
    return 1234.5


def attention_calls(config, images):
    return [(images, 5, 2, 16)] * 2, [(images, 5, 2, 16)]
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """An architecture `toy` added by new files alone: a reference module
    and a counts module in directories of their own, put on the search
    paths; no file of the benchmark is touched."""
    (tmp_path / "arch").mkdir()
    (tmp_path / "work").mkdir()
    (tmp_path / "arch" / "toy.py").write_text(TOY_ARCH)
    (tmp_path / "work" / "toy.py").write_text(TOY_WORK)
    monkeypatch.setattr(manifest, "ARCHITECTURE_DIRS",
                        manifest.ARCHITECTURE_DIRS + [tmp_path / "arch"])
    monkeypatch.setattr(manifest, "WORK_DIRS",
                        manifest.WORK_DIRS + [tmp_path / "work"])
    config = copy.deepcopy(tiny_cell("vitb16-offline").config)
    config["architecture"] = "toy"
    return config


def _items(n: int, directory: str):
    files = images.write_set(2 ** 31 + 5, n, 100, 160, directory)
    return [(k, f, 3 * k + 1) for k, f in enumerate(files)]


def test_a_second_architecture_by_new_files_alone(toy, tmp_path):
    arch = manifest.architecture(toy)
    assert arch.IMAGE_MEAN == (0.5, 0.5, 0.5)
    names = classnames(tiny_cell("vitb16-offline").traffic)
    out = reference.logits(toy, 2 ** 31 + 9, names, _items(3, str(tmp_path)),
                           arch=arch, device=torch.device("cpu"), canvas=160,
                           block=2)
    assert sorted(out) == [0, 1, 2]
    for adapted, zero_shot in out.values():
        assert adapted.shape == zero_shot.shape == (len(names),)
        assert torch.isfinite(adapted).all()
        assert not torch.equal(adapted, zero_shot)     # the step moved it
    assert work.image_flops(toy) == 1234.5
    assert work.prefix_flops(toy) == 8 * 1 * 2.0 * 32 ** 2
    fwd, bwd = work.attention_calls(toy, 4)
    assert fwd == [work.AttentionCall(4, 5, 2, 16)] * 2 and len(bwd) == 1
    reading = types.SimpleNamespace(window_s=1.0)
    mfu = metric_reader("mfu.offline")({"reading": reading, "config": toy,
                                        "traced_images": 8})
    assert mfu == pytest.approx(100.0 * 8 * 1234.5 / 989e12)


def test_clip_is_the_default():
    config = tiny_cell("vitb16-offline").config
    assert "architecture" not in config
    named = dict(config, architecture="clip")
    assert manifest.architecture_name(config) == "clip"
    assert manifest.architecture(config).__file__ \
        == manifest.architecture(named).__file__
    assert work.image_flops(config) == work.image_flops(named)


@pytest.mark.parametrize("name", ["no-such-arch", "../arch/clip", ""])
def test_unknown_architecture_raises(name):
    config = {"architecture": name}
    with pytest.raises(KeyError, match="known: clip"):
        manifest.architecture(config)
    with pytest.raises(KeyError, match="known: clip"):
        work.image_flops(config)


def test_no_key_and_clip_key_check_alike(tmp_path):
    """The same window's answers, judged once under a configuration with no
    `architecture` key and once under one that names CLIP: the same
    checks, number for number."""
    cell = tiny_cell("vitb16-offline")
    res = run_cpu(cell, tmp_path=tmp_path)
    named = copy.deepcopy(cell)
    named.config["architecture"] = "clip"
    seed = 2 ** 31 + 77
    ok, checks = session.check(cell, res, seed, torch.device("cpu"))
    ok_named, checks_named = session.check(named, res, seed,
                                           torch.device("cpu"))
    assert ok and ok_named
    assert checks == checks_named == res["checks"]


class FakeTracer:
    """The profiler's place in the offline driver, on the CPU."""

    def __init__(self, out_path, device):
        self.out_path = out_path

    def start(self):
        pass

    def stop(self):
        pass


def test_traced_offline_run_carries_every_counter(tmp_path, monkeypatch):
    from benchmark.harness import trace

    monkeypatch.setattr(trace, "Tracer", FakeTracer)
    cell = tiny_cell("vitb16-offline")
    cell.check["trace"] = {"after_s": 0.3, "span_s": 0.3}
    torch.set_num_threads(2)
    res = session.execute(cell, 2 ** 31 + 78, 1.0, True, torch.device("cpu"),
                          time.time(), str(tmp_path))
    names = {p.stem for p in counters.DIR.glob("*.json")}
    assert names == set(counters.read())
    assert {"attention_bshd.fwd_launches", "attention_bshd.bwd_launches",
            "quant.linear_q.launches", "ln_matmul.launches",
            "ln_matmul.linear_launches"} <= names
    assert set(res["counters"]) == names == set(res["launches"])
    assert all(isinstance(v, int) and v >= 0
               for v in res["counters"].values())
    assert res["traced_steps"] >= 2 and res["correct"]


def test_a_counter_the_program_lacks_is_left_out(tmp_path, monkeypatch):
    (tmp_path / "ln_matmul.launches.json").write_text(
        '{"module": "ttl_tpu_torch.ops.ln_matmul", '
        '"attribute": "ln_matmul.launches"}')
    (tmp_path / "gone.json").write_text(
        '{"module": "ttl_tpu_torch.ops.ln_matmul", "attribute": "gone"}')
    (tmp_path / "nowhere.json").write_text(
        '{"module": "ttl_tpu_torch.ops.nowhere", "attribute": "n"}')
    monkeypatch.setattr(counters, "DIR", tmp_path)
    assert set(counters.read()) == {"ln_matmul.launches"}
    assert counters.grown({"a": 2, "b": 1}, {"a": 5, "c": 0}) == {"a": 3}

