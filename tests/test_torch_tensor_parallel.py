"""The model axis (`--mesh_shape d,m`, m > 1) over gloo ranks on the CPU,
against the JAX package's GSPMD model axis and against one process.

Two ranks on mesh (1, 2) run every mode's step (`tests/torch_mesh_cases.py`)
on their halves of JAX's tiny weights (`shard_params`: q/k/v and fc1 by
columns, o and fc2 by rows, one head a rank), and one process runs the same
steps on the whole weights:
- `make_sharded_ttl_fn` equals JAX's on a (4, 2) mesh within 2e-3
  (tests/test_parallel.py), at 5 classes (the classifier whole on each rank)
  and at 6 (split by classes, the logits gathered);
- the gradient each LoRA step hands AdamW at its first update equals one
  process's on both ranks, |difference| <= 1e-5 + 1e-5 |one process's|: a
  gradient summed over the ranks where each already holds the whole one
  would be twice as large. The adapters' B starts non-zero, so A's
  gradient, summed over the ranks, is not zero either;
- every mode's results (image-LoRA, TPT on LoRA, text-LoRA, the int8
  prefix, PLPD, AugMix, prompt tuning, CoCoOp, zero-shot, a fused `qkv`
  tower) equal one process's within 1e-4 + 1e-4 |one process's| (f32 sums
  in another order, then AdamW's step), and the two ranks' bit for bit;
  `runner.run` with `mesh_shape` (1, 2) counts top-1/top-5 as one
  process.

Four ranks on mesh (2, 2) run `runner.run`: their top-1/top-5 equal one
process's and `ttl_tpu.runner.run`'s. One process: `shard_params` leaves
the ResNet towers and `prefix_q` whole and gives a fused `qkv` each rank's
heads of q, k and v.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads
from test_torch_image import jax_draws, stack_draws
from torch_mesh_cases import CFG_KW, CLASSES, run_cases, write_inputs
from ttl_tpu import runner as jrunner
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.data.views import ArrayDataset as JArrayDataset
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.convert import save_pytree
from ttl_tpu.models.prompts import build_text_classifier, prompt_tokens
from ttl_tpu.models.resnet import ResNetVisionConfig, init_resnet_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import quant as jq
from ttl_tpu.ops.lora import init_adapters
from ttl_tpu.parallel import eval as jeval
from ttl_tpu.parallel import mesh as jmesh
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
GRAD_TOL = 1e-5
OUT_TOL = 1e-4


def spawn_ranks(tmp, script: str, argv, world: int, name: str = "worker",
                timeout: float = 300) -> list:
    """Run `script` in `world` gloo ranks (RANK r, a free MASTER_PORT on
    127.0.0.1); each must exit 0 and print one `RESULT:` JSON line, which
    comes back parsed, by rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**test_torch_threads.subprocess_env(), "WORLD_SIZE": str(world),
           "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS, env.get("PYTHONPATH", "")])
    path = tmp / f"{name}.py"
    path.write_text(script)
    procs = [subprocess.Popen([sys.executable, str(path), *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO,
                              env={**env, "RANK": str(r)})
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("RESULT:"))[len("RESULT:"):])
            for out, _ in outs]


CASES_WORKER = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch_mesh_cases import run_cases
    from ttl_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method="env://")
    mesh = make_mesh((1, 2), "cpu")
    out = run_cases(sys.argv[1], mesh)
    out["model index"] = mesh.model.index
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(out), flush=True)
""")


def jax_adapters(seed: int, width: int) -> dict:
    """JAX's adapters for the 2-layer window, B made non-zero (numpy) so that
    A's gradient is not zero at the first update."""
    tree = init_adapters(jax.random.PRNGKey(seed), 2, width, CFG_KW["rank"],
                         "xavier")
    rng = np.random.default_rng(seed)
    return {m: {"A": np.asarray(ab["A"]),
                "B": (0.05 * rng.standard_normal(ab["B"].shape)
                      ).astype(np.float32)}
            for m, ab in tree.items()}


@pytest.fixture(scope="module")
def model_axis(tmp_path_factory):
    """The two ranks' results, one process's, and what JAX is given."""
    tmp = tmp_path_factory.mktemp("model_axis")
    params = init_clip_params(jax.random.PRNGKey(0), J_TINY)
    text_cls = {n: np.asarray(build_text_classifier(
        params["text"], jnp.asarray(prompt_tokens(
            [f"class {i}" for i in range(n)])), J_TINY.text,
        compute_dtype=jnp.float32)) for n in (5, 6)}
    adapters = jax_adapters(1, J_TINY.vision.hidden)
    write_inputs(tmp, params, adapters, jax_adapters(2, J_TINY.text.hidden),
                 text_cls, prompt_tokens(CLASSES), save_pytree)
    ranks = spawn_ranks(tmp, CASES_WORKER, [str(tmp)], 2)
    return dict(tmp=tmp, params=params, adapters=adapters, text_cls=text_cls,
                ranks=ranks, one=run_cases(str(tmp)))


@pytest.mark.parametrize("n_classes", [5, 6])
def test_sharded_step_matches_jax_on_a_four_by_two_mesh(model_axis,
                                                        n_classes):
    jm = jmesh.make_mesh((4, 2))
    fn = jeval.make_sharded_ttl_fn(J_TINY, JTTLConfig(**CFG_KW), jm,
                                   n_classes=n_classes)
    views = jnp.asarray(np.load(model_axis["tmp"] / "data.npz")["views"])
    keys = jax.random.split(jax.random.PRNGKey(3), views.shape[0])
    res = fn(jmesh.shard_params(model_axis["params"], jm),
             *jmesh.replicate((jnp.asarray(model_axis["text_cls"][n_classes]),
                               model_axis["adapters"]), jm),
             jmesh.shard_batch(views, jm), jmesh.shard_batch(keys, jm))
    want = np.asarray(res.logits)
    assert [r["model index"] for r in model_axis["ranks"]] == [0, 1]
    for rank in model_axis["ranks"]:
        got = np.asarray(rank[f"image-LoRA, {n_classes} classes"]["logits"])
        assert got.shape == (views.shape[0], n_classes)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


GRAD_CASES = ["image-LoRA, 5 classes", "image-LoRA, 6 classes",
              "TPT on LoRA", "text-LoRA", "int8 prefix", "PLPD", "AugMix"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_adapter_gradients_equal_one_process_on_both_ranks(model_axis, case):
    want = np.asarray(model_axis["one"][case]["grad"])
    n_a = 2 * 2 * CFG_KW["rank"] * J_TINY.vision.hidden
    # the leaves are A, B of q, then A, B of v: A's part is not zero
    assert np.abs(want[:n_a // 2]).max() > 0
    for rank in model_axis["ranks"]:
        got = np.asarray(rank[case]["grad"])
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


ALL_CASES = GRAD_CASES + ["prompt tuning", "CoCoOp", "zero-shot",
                          "fused qkv", "runner"]


@pytest.mark.parametrize("case", ALL_CASES)
def test_every_mode_on_the_model_axis_equals_one_process(model_axis, case):
    want = model_axis["one"][case]
    first, second = model_axis["ranks"]
    assert first[case] == second[case]
    for key, value in want.items():
        if key == "grad":
            continue
        np.testing.assert_allclose(np.asarray(first[case][key]),
                                   np.asarray(value), rtol=OUT_TOL,
                                   atol=OUT_TOL, err_msg=f"{case}: {key}")


N_SAMPLES, V = 13, 8
RUNNER_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.data.views import ArrayDataset
    from ttl_tpu_torch.models.convert import adapters_from_numpy, load_pytree

    dist.init_process_group("gloo", init_method="env://")
    tmp = sys.argv[1]
    data = np.load(tmp + "/data.npz")
    adapters0 = load_pytree(tmp + "/adapters.npz")
    runner.make_adapters0 = lambda cfg, clip_cfg, device: \\
        adapters_from_numpy(adapters0, device)
    runner.draw_batch = lambda seed, indices, n: {
        k: torch.from_numpy(np.stack([data["draw_" + k][int(i)]
                                      for i in indices]))
        for k in ("area", "log_ratio", "pos", "flip")}
    ds = ArrayDataset(data["images"], data["labels"])
    out = {}
    for sample_batch in (8, 4):
        cfg = TTLConfig(**json.loads(sys.argv[2]), sample_batch=sample_batch,
                        mesh_shape=(2, 2),
                        checkpoint_path=tmp + "/params.npz")
        out[f"run {sample_batch}"] = runner.run(
            cfg, device="cpu", datasets={"eurosat": ds})["eurosat"]
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(out), flush=True)
""")


def test_four_ranks_on_a_two_by_two_mesh_count_as_one_process(
        tmp_path, monkeypatch):
    kw = dict(CFG_KW, test_sets="eurosat", print_freq=1000)
    rng = np.random.RandomState(0)
    images = (rng.rand(N_SAMPLES, 80, 96, 3) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, size=N_SAMPLES)
    params = init_clip_params(jax.random.PRNGKey(0), J_TINY,
                              param_dtype=jnp.float32)
    adapters = jax_adapters(1, J_TINY.vision.hidden)
    save_pytree(str(tmp_path / "params.npz"), params)
    save_pytree(str(tmp_path / "adapters.npz"), adapters)
    draws = [jax_draws(sample_key(JTTLConfig().seed, i), V)
             for i in range(N_SAMPLES)]
    np.savez(tmp_path / "data.npz", images=images, labels=labels,
             **{"draw_" + k: np.stack([d[k] for d in draws])
                for k in draws[0]})
    ranks = spawn_ranks(tmp_path, RUNNER_WORKER,
                        [str(tmp_path), json.dumps(kw)], 4)

    j_adapters = jax.tree.map(jnp.asarray, adapters)
    monkeypatch.setattr(jrunner, "make_adapters0",
                        lambda cfg, clip_cfg: j_adapters)
    want = jrunner.run(
        JTTLConfig(**kw, sample_batch=8,
                   checkpoint_path=str(tmp_path / "params.npz")),
        datasets={"eurosat": JArrayDataset(images, labels)})["eurosat"]
    monkeypatch.setattr(trunner, "make_adapters0",
                        lambda cfg, clip_cfg, device: adapters_from_numpy(
                            adapters, device))
    monkeypatch.setattr(trunner, "draw_batch", lambda seed, indices, n:
                        stack_draws([draws[int(i)] for i in indices]))
    one = trunner.run(
        TTLConfig(**kw, sample_batch=8,
                  checkpoint_path=str(tmp_path / "params.npz")),
        device="cpu", datasets={"eurosat": ArrayDataset(images, labels)}
    )["eurosat"]
    np.testing.assert_allclose(one, want, rtol=0, atol=1e-9)
    for rank in ranks:
        for sample_batch in (8, 4):
            np.testing.assert_allclose(rank[f"run {sample_batch}"], one,
                                       rtol=0, atol=1e-9)


def rank_mesh(shape, rank):
    return Mesh(dict(zip((DATA_AXIS, MODEL_AXIS), shape)), rank,
                int(np.prod(shape)), torch.device("cpu"))


def test_shard_params_leaves_resnet_towers_and_the_int8_prefix_whole():
    cfg = TTLConfig(arch="test-tiny", prefix_quant="int8")
    vit = params_from_numpy(jq.attach_prefix_quant(
        init_clip_params(jax.random.PRNGKey(0), J_TINY),
        jq.quant_prefix_len(cfg, J_TINY)), "cpu")
    rn = params_from_numpy({"vision": init_resnet_params(
        jax.random.PRNGKey(0), ResNetVisionConfig(
            layers=(1, 1, 1, 1), width=16, heads=4, proj_dim=16,
            image_size=64))}, "cpu")
    for rank in (0, 1, 3):
        mesh = rank_mesh((2, 2), rank)
        placed = shard_params(rn, mesh)
        for a, b in zip(jax.tree.leaves(rn), jax.tree.leaves(placed)):
            assert a is b
        placed = shard_params(vit, mesh)
        for a, b in zip(jax.tree.leaves(vit["vision"]["prefix_q"]),
                        jax.tree.leaves(placed["vision"]["prefix_q"])):
            assert a is b
        assert placed["logit_scale"] is vit["logit_scale"]
        j = rank % 2
        for tower in ("vision", "text"):
            whole, part = vit[tower]["layers"], placed[tower]["layers"]
            torch.testing.assert_close(
                part["attn"]["q"]["w"], whole["attn"]["q"]["w"][
                    :, :, 16 * j:16 * (j + 1)], rtol=0, atol=0)
            torch.testing.assert_close(
                part["mlp"]["fc2"]["w"], whole["mlp"]["fc2"]["w"][
                    :, 64 * j:64 * (j + 1)], rtol=0, atol=0)
            assert part["attn"]["o"]["b"] is whole["attn"]["o"]["b"]
            assert part["mlp"]["fc1"]["b"].shape == (4, 64)


def test_a_fused_qkv_keeps_each_ranks_heads_of_q_k_and_v():
    from ttl_tpu_torch.models.clip import fuse_qkv_params
    gen = torch.Generator().manual_seed(0)
    width, heads = 8, 4
    tower = {"layers": {"attn": {
        name: {"w": torch.randn(1, width, width, generator=gen),
               "b": torch.randn(1, width, generator=gen)}
        for name in "qkvo"}}}
    fused = fuse_qkv_params(tower)
    for m in (2, 4):
        cols = width // m
        for j in range(m):
            part = shard_params({"vision": fused}, rank_mesh((1, m), j))
            qkv = part["vision"]["layers"]["attn"]["qkv"]
            for key in ("w", "b"):
                want = torch.cat([tower["layers"]["attn"][name][key][
                    ..., j * cols:(j + 1) * cols] for name in "qkv"], dim=-1)
                torch.testing.assert_close(qkv[key], want, rtol=0, atol=0)
            assert heads * cols % width == 0
    bad = {"vision": {"layers": {"attn": {"qkv": {
        "w": torch.zeros(1, 8, 20)}}}}}
    with pytest.raises(ValueError, match="q, k, v blocks"):
        shard_params(bad, rank_mesh((1, 2), 0))
    with pytest.raises(ValueError, match="does not split"):
        shard_params({"vision": {"layers": {"mlp": {"fc1": {
            "w": torch.zeros(1, 8, 9)}}}}}, rank_mesh((1, 2), 1))
