"""The port stands on its own: it imports torch, never jax, and nothing of
the JAX package `ttl_tpu`; it keeps its own copy of the modules it shares
with it. A subprocess runs the port end to end on the CPU and lists the
modules it loaded; in-process cases hold each copy against its original.
"""
import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import test_torch_threads
from ttl_tpu import cli as jcli
from ttl_tpu import config as jconfig
from ttl_tpu.data import bongard as jbongard
from ttl_tpu.data import classnames as jclassnames
from ttl_tpu.data import registry as jregistry
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.tokenizer import bpe as jbpe
from ttl_tpu.utils import meters as jmeters
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import config as tconfig
from ttl_tpu_torch.data import bongard as tbongard
from ttl_tpu_torch.data import classnames as tclassnames
from ttl_tpu_torch.data import registry as tregistry
from ttl_tpu_torch.models import prompts as tprompts
from ttl_tpu_torch.tokenizer import bpe as tbpe
from ttl_tpu_torch.utils import meters as tmeters

RUN = """
import os, sys, tempfile
import numpy as np
import torch
import ttl_tpu_torch.cli, ttl_tpu_torch.runner, ttl_tpu_torch.adapt.ttl
import ttl_tpu_torch.models.prompts, ttl_tpu_torch.ops.quant
import ttl_tpu_torch.adapt.cocoop, ttl_tpu_torch.ops.ln_matmul
import ttl_tpu_torch.utils.checkpoint, ttl_tpu_torch.models.convert
import ttl_tpu_torch.models.resnet
import ttl_tpu_torch.predict, ttl_tpu_torch.serve
import ttl_tpu_torch.adapt.bongard, ttl_tpu_torch.data.bongard
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models.clip import CLIPConfig
from ttl_tpu_torch.models.resnet import ResNetVisionConfig
from ttl_tpu_torch.models.zoo import TEST_TINY

rng = np.random.default_rng(0)
ds = ArrayDataset(rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
                  np.array([3, 1]))
for mode in ({}, {"lora_encoder": "text"}, {"lora_encoder": "prompt"},
             {"cocoop": True},
             {"filter_plpd": 1, "aug_ops": ("rotate", "equalize")}):
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=8,
                    sample_batch=2, compute_dtype="float32",
                    param_dtype="float32", workers=1, **mode)
    top1, top5 = ttl_tpu_torch.runner.run(cfg, device="cpu",
                                          datasets={"A": ds})["A"]
    assert 0.0 <= top1 <= top5 <= 100.0
# a tiny ResNet tower, its weights through a checkpoint cache
tiny = CLIPConfig(vision=ResNetVisionConfig(layers=(1, 1, 1, 1), width=16,
                                            heads=4, proj_dim=16,
                                            image_size=64),
                  text=TEST_TINY.text)
cfg = TTLConfig(arch="RN50", resolution=64, batch_size=8, sample_batch=2,
                compute_dtype="float32", param_dtype="float32", workers=1,
                lora_encoder="prompt")
params = ttl_tpu_torch.models.clip.init_clip_params(
    tiny, torch.Generator().manual_seed(0), device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    cache = os.path.join(tmp, "rn.npz")
    ttl_tpu_torch.models.convert.save_pytree(cache, params)
    tree, _ = ttl_tpu_torch.models.convert.load_checkpoint(cache, tiny)
params = ttl_tpu_torch.models.convert.params_from_numpy(tree, "cpu")
top1, top5 = ttl_tpu_torch.runner.evaluate_dataset(
    "cifar10", cfg, tiny, params, None, device="cpu", dataset=ds)
assert 0.0 <= top1 <= top5 <= 100.0
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ttl_tpu"))
assert not foreign, foreign
assert {"ttl_tpu_torch.predict", "ttl_tpu_torch.serve",
        "ttl_tpu_torch.adapt.bongard",
        "ttl_tpu_torch.data.bongard"} <= set(sys.modules)
print("STANDALONE OK")
"""


def test_port_runs_end_to_end_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN)],
                          capture_output=True, text=True, timeout=600,
                          env=test_torch_threads.subprocess_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDALONE OK" in proc.stdout


def test_no_source_file_of_the_port_imports_jax_or_the_jax_package():
    import re
    from pathlib import Path
    root = Path(tconfig.__file__).resolve().parent
    pattern = re.compile(r"^\s*(from|import)\s+(jax|ttl_tpu)(\.|\s|$)", re.M)
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not pattern.search(path.read_text()), path


ARGVS = [
    ["data"],
    ["--data", "root", "--test_sets", "A/V/R/K", "-a", "ViT-L/14",
     "--resolution", "336", "-j", "2", "-b", "32", "--lr", "1e-3",
     "-p", "5", "--gpu", "1", "--tpt", "--selection_p", "0.2",
     "--tta_steps", "2", "--n_ctx", "8", "--ctx_init", "a_photo_of_the",
     "--seed", "7", "--images_per_class", "3"],
    ["data", "--lora_encoder", "text", "--layer_range", "8,11", "--rank",
     "8", "--init_method", "kaiming", "--deyo_selection", "False"],
    ["data", "--lora_encoder", "prompt", "--load", "ctx.pth", "--cocoop",
     "--ensemble", "--init_method", "None", "--deyo_selection", "true"],
    ["data", "--aug_type", "occ", "--occlusion_size", "64", "--patch_len",
     "4", "--row_start", "8", "--column_start", "9", "--deyo_margin", "0.3",
     "--deyo_margin_e0", "0.5", "--plpd_threshold", "0.1", "--fishers", "1",
     "--filter_ent", "1", "--filter_plpd", "1", "--reweight_ent", "0",
     "--reweight_plpd", "1", "--aug_list", "rotate,equalize",
     "--aug_severity", "2"],
    ["data", "--sample_batch", "4", "--canvas", "256", "--pipeline_depth",
     "3", "--checkpoint_path", "clip.pt", "--compute_dtype", "float32",
     "--param_dtype", "float32", "--prefix_quant", "int8", "--mesh_shape",
     "2,2", "--results_json", "out.json", "--dataset_mode", "val"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_config_from_args_matches_the_jax_cli(argv):
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_parsers_have_the_same_flags_and_defaults():
    def table(parser):
        return {tuple(a.option_strings) or a.dest: (a.dest, a.default,
                                                    a.nargs, a.choices)
                for a in parser._actions}
    assert table(tcli.build_parser()) == table(jcli.build_parser())


def test_config_copy_has_the_same_fields_and_helpers():
    assert dataclasses.asdict(tconfig.TTLConfig()) == dataclasses.asdict(
        jconfig.TTLConfig())

    @dataclasses.dataclass
    class Tower:
        layers: int

    @dataclasses.dataclass
    class Clip:
        vision: Tower
        text: Tower

    clip = Clip(Tower(24), Tower(12))
    for kw in ({}, {"lora_encoder": "text"}, {"lora_encoder": "prompt"},
               {"layer_range": (3, 5)}, {"tta_steps": 3},
               {"tta_steps": 3, "deyo_selection": False},
               {"tta_steps": 3, "lora_encoder": "prompt"}):
        t, j = tconfig.TTLConfig(**kw), jconfig.TTLConfig(**kw)
        assert tconfig.resolve_layer_range(t, clip) == \
            jconfig.resolve_layer_range(j, clip)
        assert tconfig.effective_update_steps(t) == \
            jconfig.effective_update_steps(j)


@pytest.mark.parametrize("set_id", ["A", "flower102"])
def test_tokenizer_and_classnames_copies_agree(set_id):
    names = tclassnames.resolve_classnames(set_id)
    assert list(names) == list(jclassnames.resolve_classnames(set_id))
    prompts = tprompts.format_prompts(names)
    assert prompts == jprompts.format_prompts(names)
    want = np.asarray(jbpe.tokenize(prompts))
    got = np.asarray(tbpe.tokenize(prompts))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tprompts.prompt_tokens(names, "a photo of"),
                                  jprompts.prompt_tokens(names, "a photo of"))
    assert tprompts.needed_ctx_len(got) == jprompts.needed_ctx_len(want)


def test_templates_and_registry_copies_agree():
    assert tprompts.load_imagenet_templates() == \
        jprompts.load_imagenet_templates()
    assert tregistry.ID_TO_DIRNAME == jregistry.ID_TO_DIRNAME
    for set_id in ["I", "A", "cifar10", "flower102", "nope"]:
        assert tregistry.expected_subdir(set_id) == \
            jregistry.expected_subdir(set_id)

    def bongard_set(registry, config):
        return registry.build_dataset("bongard", config.TTLConfig(
            data="root", dataset_mode="test"))
    # both read the split file from data/bongard_splits under the working
    # directory; without it both raise the same error
    with pytest.raises(FileNotFoundError) as got:
        bongard_set(tregistry, tconfig)
    with pytest.raises(FileNotFoundError) as want:
        bongard_set(jregistry, jconfig)
    assert str(got.value) == str(want.value)


def test_meters_copy_agrees():
    rng = np.random.default_rng(0)
    out, target = rng.standard_normal((9, 6)), rng.integers(0, 6, 9)
    assert tmeters.accuracy(out, target, (1, 5)) == \
        jmeters.accuracy(out, target, (1, 5))
    t, j = (m.AverageMeter("Acc", ":6.2f", m.Summary.AVERAGE)
            for m in (tmeters, jmeters))
    for m in (t, j):
        m.update(50.0, 2)
        m.update(100.0, 1)
    assert (str(t), t.summary()) == (str(j), j.summary())


def test_bongard_copy_agrees(tmp_path, monkeypatch):
    """The same split file gives the same episodes: the seed-0 shuffle, the
    support and query order, the annotation and the val<->train picture
    path fallback; and the registry builds it from the same place."""
    import json
    import os
    pics = tmp_path / "hake" / "pic" / "image"
    for split in ("train", "val"):
        (pics / split).mkdir(parents=True)

    def item(t, i, polarity):
        """A picture listed under one split; every third one is on disk
        only under the other."""
        listed = ("train", "val")[i % 2]
        on_disk = listed if (i + t) % 3 else ("val", "train")[i % 2]
        name = f"t{t}_{polarity}{i}.jpg"
        (pics / on_disk / name).write_bytes(b"")
        return {"im_path": f"./hake/pic/image/{listed}/{name}"}

    tasks = [[[item(t, i, "n") for i in range(7)],
              [item(t, i, "p") for i in range(7)], f"ride++horse{t}"]
             for t in range(3)]
    splits = tmp_path / "data" / "bongard_splits"
    splits.mkdir(parents=True)
    (splits / "bongard_hoi_val_seen_obj_seen_act.json").write_text(
        json.dumps(tasks))
    (splits / "bongard_hoi_test_unseen_obj_unseen_act.json").write_text(
        json.dumps(tasks[:2]))
    monkeypatch.chdir(tmp_path)
    got, want = (m.BongardDataset(str(tmp_path), "seen_obj_seen_act",
                                  mode="val", with_annotation=True)
                 for m in (tbongard, jbongard))
    assert len(got) == len(want) == 3
    for i in range(3):
        assert dataclasses.asdict(got[i]) == dataclasses.asdict(want[i])
        assert all(map(os.path.isfile, got[i].support_paths
                       + got[i].query_paths))
    built = [r.build_dataset("bongard", c.TTLConfig(data=str(tmp_path)))
             for r, c in ((tregistry, tconfig), (jregistry, jconfig))]
    assert type(built[0]) is tbongard.BongardDataset
    assert len(built[0]) == len(built[1]) == 2
    assert dataclasses.asdict(built[0][1]) == dataclasses.asdict(built[1][1])


def test_tokenizer_copy_agrees_on_the_ensemble_prompts():
    """Set A's 200 classes under the 80 templates, the ensemble classifier's
    16,000 prompts: the same tokens from both packages."""
    names = tclassnames.resolve_classnames("A")
    prompts = [t.format(c.replace("_", " "))
               for c in names for t in tprompts.load_imagenet_templates()]
    assert len(prompts) == 16000
    np.testing.assert_array_equal(np.asarray(tbpe.tokenize(prompts)),
                                  np.asarray(jbpe.tokenize(prompts)))


def test_tokenizer_resolves_ftfy_once(monkeypatch):
    """Cleaning a prompt searches for no module: whether ftfy is there was
    settled when the tokenizer was imported."""
    import builtins
    real_import = builtins.__import__

    def no_ftfy(name, *args, **kw):
        if name == "ftfy":
            raise AssertionError("ftfy looked up at a call")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_ftfy)
    assert tbpe._clean("a  photo of a &amp; goldfish. ") == \
        "a photo of a & goldfish."
