"""Data-parallel evaluation over two processes on the CPU, against the JAX
package's single-host results.

The test starts two gloo ranks with `subprocess`, as tests/test_multihost.py
starts its two JAX hosts (MASTER_ADDR 127.0.0.1, a free port). Each rank
loads its shard of the seed-shared sample order and runs the single-card
step; the counts are summed over the ranks once a batch.

- `runner.run` over 13 samples at `sample_batch` 8 (shards of 7 and 6
  samples) and at 4 (the second rank then dispatches an all-padding filler
  batch): the top-1/top-5 on both ranks equal a one-process run of the port
  and `ttl_tpu.runner.run` on the same dataset. Both packages read the same
  weights (an .npz of JAX's parameters, `--checkpoint_path`); the port is
  handed JAX's adapters and view draws.
- `parallel.eval.make_sharded_ttl_fn` over the two ranks against JAX's over
  a 2-device data mesh, within 2e-4 (tests/test_parallel.py).
- `sharded_topk_correct` on the cases of tests/test_parallel.py.
- `--test_sets bongard` is not sharded: under two ranks it raises
  ValueError before any work.
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

import test_torch_threads
from test_torch_image import jax_draws, stack_draws
from ttl_tpu import runner as jrunner
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.data.views import ArrayDataset as JArrayDataset
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.convert import save_pytree
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops.lora import init_adapters
from ttl_tpu.parallel import eval as jeval
from ttl_tpu.parallel import mesh as jmesh
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models.convert import adapters_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES, V, RANK = 13, 8, 4
RUN_KW = dict(arch="test-tiny", resolution=64, batch_size=V,
              layer_range=(2, 3), rank=RANK, test_sets="eurosat",
              compute_dtype="float32", param_dtype="float32",
              print_freq=1000)

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.data.views import ArrayDataset
    from ttl_tpu_torch.models.convert import (adapters_from_numpy,
                                              load_pytree, params_from_numpy)
    from ttl_tpu_torch.models.zoo import TEST_TINY
    from ttl_tpu_torch.parallel.eval import (make_sharded_ttl_fn,
                                             sharded_topk_correct)
    from ttl_tpu_torch.parallel.mesh import make_mesh, shard_batch

    dist.init_process_group("gloo", init_method="env://")
    tmp = sys.argv[1]
    data = np.load(tmp + "/data.npz")
    adapters0 = load_pytree(tmp + "/adapters.npz")
    draws = {int(i): {k: data["draw_" + k][i]
                      for k in ("area", "log_ratio", "pos", "flip")}
             for i in range(len(data["labels"]))}
    runner.make_adapters0 = lambda cfg, clip_cfg, device: \\
        adapters_from_numpy(adapters0, device)
    runner.draw_batch = lambda seed, indices, n: {
        k: torch.from_numpy(np.stack([draws[int(i)][k] for i in indices]))
        for k in draws[0]}
    out = {}
    ds = ArrayDataset(data["images"], data["labels"])
    for sample_batch in (8, 4):
        cfg = TTLConfig(**json.loads(sys.argv[2]), sample_batch=sample_batch,
                        checkpoint_path=tmp + "/params.npz")
        out[f"run {sample_batch}"] = runner.run(
            cfg, device="cpu", datasets={"eurosat": ds})["eurosat"]

    mesh = make_mesh(device="cpu")
    cfg = TTLConfig(**json.loads(sys.argv[2]))
    step = make_sharded_ttl_fn(TEST_TINY, cfg, mesh)
    res = step(params_from_numpy(load_pytree(tmp + "/params.npz"), "cpu"),
               torch.from_numpy(data["text_cls"]),
               adapters_from_numpy(adapters0, "cpu"),
               shard_batch(torch.from_numpy(data["views"]), mesh))
    out["sharded logits"] = res.logits.tolist()
    out["sharded losses"] = list(res.losses.shape)
    logits = torch.from_numpy(data["topk_logits"])
    labels = logits.argmax(dim=-1)
    out["topk"] = [sharded_topk_correct(*shard_batch((logits, y), mesh),
                                        topk=(1, 5)).tolist()
                   for y in (labels, (labels + 1) % 10)]
    try:
        runner.run(TTLConfig(**json.loads(sys.argv[2]) | {
            "test_sets": "bongard"}), device="cpu", datasets={})
    except ValueError as e:
        out["bongard"] = str(e)
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(out), flush=True)
""")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks' results, and what they are held against."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.RandomState(0)
    images = (rng.rand(N_SAMPLES, 80, 96, 3) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, size=N_SAMPLES)
    params = init_clip_params(jax.random.PRNGKey(0), J_TINY,
                              param_dtype=jnp.float32)
    adapters0 = init_adapters(jax.random.PRNGKey(1), 2, J_TINY.vision.hidden,
                              RANK, "xavier")
    save_pytree(str(tmp / "params.npz"), params)
    save_pytree(str(tmp / "adapters.npz"), adapters0)
    seed = JTTLConfig().seed
    draws = [jax_draws(sample_key(seed, i), V) for i in range(N_SAMPLES)]
    text_cls = rng.randn(5, J_TINY.vision.proj_dim)
    text_cls = (text_cls / np.linalg.norm(text_cls, axis=-1, keepdims=True)
                ).astype(np.float32)
    views = rng.randn(4, V, 3, 64, 64).astype(np.float32)
    topk_logits = rng.randn(8, 10).astype(np.float32)
    np.savez(tmp / "data.npz", images=images, labels=labels,
             text_cls=text_cls, views=views, topk_logits=topk_logits,
             **{"draw_" + k: np.stack([d[k] for d in draws])
                for k in draws[0]})

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**test_torch_threads.subprocess_env(), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp), json.dumps(RUN_KW)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**env, "RANK": str(r)}) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("RESULT:"))[len("RESULT:"):])
             for out, _ in outs]
    return dict(tmp=tmp, images=images, labels=labels, params=params,
                adapters0=adapters0, draws=draws, text_cls=text_cls,
                views=views, ranks=ranks, stdout=[o for o, _ in outs])


def test_two_rank_runner_matches_one_process_and_the_jax_runner(
        spawned, monkeypatch):
    tmp = spawned["tmp"]
    want = jrunner.run(
        JTTLConfig(**RUN_KW, sample_batch=8,
                   checkpoint_path=str(tmp / "params.npz")),
        datasets={"eurosat": JArrayDataset(spawned["images"],
                                           spawned["labels"])})["eurosat"]
    monkeypatch.setattr(trunner, "make_adapters0",
                        lambda cfg, clip_cfg, device: adapters_from_numpy(
                            spawned["adapters0"], device))
    monkeypatch.setattr(trunner, "draw_batch", lambda seed, indices, n:
                        stack_draws([spawned["draws"][int(i)]
                                     for i in indices]))
    one = trunner.run(
        TTLConfig(**RUN_KW, sample_batch=8,
                  checkpoint_path=str(tmp / "params.npz")),
        device="cpu", datasets={"eurosat": ArrayDataset(
            spawned["images"], spawned["labels"])})["eurosat"]
    np.testing.assert_allclose(one, want, rtol=0, atol=1e-9)
    for rank in spawned["ranks"]:
        for sample_batch in (8, 4):
            np.testing.assert_allclose(rank[f"run {sample_batch}"], one,
                                       rtol=0, atol=1e-9)


def test_only_rank_zero_prints_the_summary(spawned):
    first, second = spawned["stdout"]
    assert first.count("======== Result Summary ========") == 2
    assert "Result Summary" not in second and "=> Acc." not in second


def test_sharded_ttl_fn_matches_jax_over_a_two_device_mesh(spawned):
    mesh = jmesh.make_mesh((2,), devices=jax.devices()[:2])
    cfg = JTTLConfig(**RUN_KW)
    fn = jeval.make_sharded_ttl_fn(J_TINY, cfg, mesh)
    views = jnp.asarray(spawned["views"])
    keys = jax.random.split(jax.random.PRNGKey(3), views.shape[0])
    res = fn(jmesh.shard_params(spawned["params"], mesh),
             *jmesh.replicate((jnp.asarray(spawned["text_cls"]),
                               spawned["adapters0"]), mesh),
             jmesh.shard_batch(views, mesh), jmesh.shard_batch(keys, mesh))
    want = np.asarray(res.logits)
    for rank in spawned["ranks"]:
        assert rank["sharded losses"][0] == views.shape[0]
        np.testing.assert_allclose(np.asarray(rank["sharded logits"]), want,
                                   rtol=2e-4, atol=2e-4)


def test_sharded_topk_correct_sums_over_ranks(spawned):
    for rank in spawned["ranks"]:
        right, wrong = rank["topk"]
        assert right == [8, 8]
        assert wrong[0] == 0


def test_bongard_raises_under_two_ranks(spawned):
    for rank in spawned["ranks"]:
        assert "bongard is not sharded" in rank["bongard"]
