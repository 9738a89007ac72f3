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

from ttl_tpu import cli as jcli
from ttl_tpu import config as jconfig
from ttl_tpu.data import classnames as jclassnames
from ttl_tpu.data import registry as jregistry
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.tokenizer import bpe as jbpe
from ttl_tpu.utils import meters as jmeters
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import config as tconfig
from ttl_tpu_torch.data import classnames as tclassnames
from ttl_tpu_torch.data import registry as tregistry
from ttl_tpu_torch.models import prompts as tprompts
from ttl_tpu_torch.tokenizer import bpe as tbpe
from ttl_tpu_torch.utils import meters as tmeters

RUN = """
import sys
import numpy as np
import ttl_tpu_torch.cli, ttl_tpu_torch.runner, ttl_tpu_torch.adapt.ttl
import ttl_tpu_torch.models.prompts, ttl_tpu_torch.ops.quant
import ttl_tpu_torch.adapt.cocoop, ttl_tpu_torch.ops.ln_matmul
import ttl_tpu_torch.utils.checkpoint
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset

rng = np.random.default_rng(0)
ds = ArrayDataset(rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
                  np.array([3, 1]))
for mode in ({}, {"lora_encoder": "text"}, {"lora_encoder": "prompt"},
             {"cocoop": True}):
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=8,
                    sample_batch=2, compute_dtype="float32",
                    param_dtype="float32", workers=1, **mode)
    top1, top5 = ttl_tpu_torch.runner.run(cfg, device="cpu",
                                          datasets={"A": ds})["A"]
    assert 0.0 <= top1 <= top5 <= 100.0
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ttl_tpu"))
assert not foreign, foreign
print("STANDALONE OK")
"""


def test_port_runs_end_to_end_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN)],
                          capture_output=True, text=True, timeout=600)
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
    with pytest.raises(NotImplementedError, match="item 16"):
        tregistry.build_dataset("bongard", tconfig.TTLConfig())


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
