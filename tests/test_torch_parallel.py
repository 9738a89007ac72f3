"""The port's mesh and counts in one process (`ttl_tpu_torch/parallel/`),
against `ttl_tpu/parallel/`; the runs over two processes are in
tests/test_torch_multiprocess.py.

- `param_spec` over every path rule and every leaf of the tiny ViT and
  ResNet trees, equal to the JAX function's PartitionSpecs on meshes with
  and without a model axis (the RN50 `attnpool/q/w` case of
  tests/test_parallel.py included).
- `make_mesh`'s shape errors; `shard_params` keeps a rank's slice on a
  model axis (tests/test_torch_tensor_parallel.py runs it); `shard_batch`
  takes the rows JAX's data-axis sharding puts on each device;
  `replicate`'s checksum sees one changed bit.
- `make_count_fn(None)` equal to JAX's `make_count_fn(None)`.
- The CLI's `--mesh_shape` / `--init_distributed` / `--gpu` checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.resnet import ResNetVisionConfig, init_resnet_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import quant as jq
from ttl_tpu.parallel import eval as jeval
from ttl_tpu.parallel import mesh as jmesh
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.parallel.eval import make_count_fn
from ttl_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                         checksum, make_mesh, param_spec,
                                         replicate, shard_batch,
                                         shard_params)

SHAPES = [(8,), (8, 1), (4, 2), (2, 4)]
RULE_PATHS = [
    "vision/layers/attn/q/w", "vision/layers/attn/k/w",
    "vision/layers/attn/v/w", "vision/layers/attn/qkv/w",
    "vision/layers/mlp/fc1/w", "vision/layers/attn/o/w",
    "vision/layers/mlp/fc2/w", "vision/layers/attn/q/b",
    "vision/layers/attn/k/b", "vision/layers/attn/v/b",
    "vision/layers/attn/qkv/b", "vision/layers/mlp/fc1/b",
    "vision/layers/attn/o/b", "vision/layers/mlp/fc2/b",
    "vision/layers/ln1/scale", "text/layers/attn/q/w",
    "vision/prefix_q/layers/attn/q/w", "vision/prefix_q/attn/q/w",
    "vision/attnpool/q/w", "vision/attnpool/q/b", "text/token_embed",
    "vision/patch_embed", "layers/attn/q/w", "attn/q/w",
]


def port_mesh(shape, rank=0):
    return Mesh(dict(zip((DATA_AXIS, MODEL_AXIS), shape)), rank,
                int(np.prod(shape)), torch.device("cpu"))


def leaf_paths(tree):
    return ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def tiny_trees():
    params = init_clip_params(jax.random.PRNGKey(0), J_TINY)
    cfg = TTLConfig(arch="test-tiny", prefix_quant="int8")
    quant = jq.attach_prefix_quant(params, jq.quant_prefix_len(cfg, J_TINY))
    rn = {"vision": init_resnet_params(jax.random.PRNGKey(0),
                                       ResNetVisionConfig(
                                           layers=(1, 1, 1, 1), width=16,
                                           heads=4, proj_dim=16,
                                           image_size=64))}
    return [params, quant, rn]


@pytest.mark.parametrize("shape", SHAPES)
def test_param_spec_matches_jax_on_every_rule_and_leaf(shape):
    jm = jmesh.make_mesh(shape)
    tm = port_mesh(shape)
    paths = RULE_PATHS + [p for tree in tiny_trees()
                          for p in leaf_paths(tree)]
    assert "vision/attnpool/q/w" in paths
    assert "vision/prefix_q/attn/q/w" in paths
    sharded = 0
    for path in paths:
        want = tuple(jmesh.param_spec(path, jm))
        assert param_spec(path, tm) == want, path
        sharded += bool(want)
    # the model-axis meshes exercise the column and row rules
    assert (sharded > 0) == (len(shape) > 1 and shape[1] > 1)


def test_make_mesh_is_the_world_of_one_process(monkeypatch):
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.world, mesh.device) == (
        {DATA_AXIS: 1}, 0, 1, torch.device("cpu"))
    assert make_mesh((1, 1), "cpu").shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_mesh().device == torch.device("cuda:3")


@pytest.mark.parametrize("shape,match", [
    ((2,), "torch.distributed.run"), ((2, 1), r"\(2, 1\) != 1 process"),
    ((0,), "positive"), ((1, 1, 1), "N,M"),
])
def test_make_mesh_raises_on_a_shape_that_is_not_the_world(shape, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(shape, "cpu")
    with pytest.raises(ValueError):
        jmesh.make_mesh(shape, devices=jax.devices()[:1])


def test_shard_params_on_a_model_axis_raises_naming_item_21():
    """The model axis is ported: the rank keeps its slice, no raise."""
    tree = {"w": torch.ones(2)}
    assert shard_params(tree, port_mesh((1,))) is tree
    q = torch.arange(16.0).reshape(1, 2, 8)
    got = shard_params({"w": tree["w"], "vision": {"layers": {"attn": {
        "q": {"w": q}}}}}, port_mesh((4, 2), rank=3))
    assert got["w"] is tree["w"]
    assert torch.equal(got["vision"]["layers"]["attn"]["q"]["w"],
                       q[..., 4:])


def test_shard_batch_takes_the_rows_jax_puts_on_each_device():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    placed = jmesh.shard_batch(jnp.asarray(x), jmesh.make_mesh((4,),
                                                              jax.devices()[:4]))
    for shard in placed.addressable_shards:
        rank = jax.devices().index(shard.device)
        got = shard_batch({"x": [torch.from_numpy(x)]},
                          port_mesh((4,), rank))["x"][0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="multiple"):
        shard_batch(torch.zeros(6), port_mesh((4,), 1))


def test_replicate_in_one_process_is_the_tree_and_its_checksum_sees_a_bit():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 5, generator=gen).to(torch.bfloat16),
            "b": [torch.randn(7, generator=gen), torch.arange(3)]}
    assert replicate(tree, port_mesh((1,))) is tree
    base = checksum(tree)
    assert base.shape == (3, 2) and base.dtype == torch.int64
    flipped = {**tree, "b": [tree["b"][0].clone(), tree["b"][1]]}
    flipped["b"][0].view(torch.int32)[2] ^= 1
    assert not torch.equal(checksum(flipped), base)
    swapped = {**tree, "b": [tree["b"][0].flip(0), tree["b"][1]]}
    assert not torch.equal(checksum(swapped), base)
    assert torch.equal(checksum({k: v for k, v in reversed(tree.items())}),
                       base)


def test_count_fn_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    logits[3, :4] = logits[3, 0]     # ties at the top
    labels = rng.integers(0, 10, 16).astype(np.int32)
    labels[3] = 2
    valid = rng.random(16) < 0.8
    want = np.asarray(jeval.make_count_fn(None)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid)))
    for mesh in (None, port_mesh((1,))):
        got = make_count_fn(mesh)(torch.from_numpy(logits),
                                  torch.from_numpy(labels).long(),
                                  torch.from_numpy(valid))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("argv,error,match", [
    (["--mesh_shape", "2"], ValueError, "torch.distributed.run"),
    (["--mesh_shape", "4,2"], ValueError, r"\(4, 2\) != 1 process"),
    (["--mesh_shape", "1,2"], ValueError, "torch.distributed.run"),
    (["--init_distributed", "--gpu", "1"], ValueError, "--gpu"),
    (["--init_distributed", "--mesh_shape", "2,2"], RuntimeError, "CUDA"),
    (["--mesh_shape", "1"], RuntimeError, "CUDA"),
    (["--mesh_shape", "1,1"], RuntimeError, "CUDA"),
    (["--init_distributed", "--mesh_shape", "2"], RuntimeError, "CUDA"),
])
def test_cli_checks_the_mesh_flags_before_the_card(monkeypatch, argv, error,
                                                   match):
    """Without --init_distributed the world is one process; with it the
    shape is held against the group's size once it is joined, on a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        tcli.main(["data", "--test_sets", "A", *argv])


@pytest.mark.parametrize("argv,local_rank,card", [
    (["--init_distributed"], "1", "cuda:1"),
    (["--init_distributed"], "0", "cuda:0"),
    (["--gpu", "2"], None, "cuda:2"),
])
def test_cli_makes_the_rank_card_current_before_it_runs(monkeypatch, argv,
                                                        local_rank, card):
    """The kernels launch on the current device's streams, so the process's
    card must be the current device before any work."""
    events = []
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: events.append(("current", str(d))))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: events.append(("join", None)))
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda: events.append(("leave", None)))
    monkeypatch.setattr(trunner, "run", lambda cfg, *, device, max_samples:
                        events.append(("run", str(device))))
    tcli.main(["data", "--test_sets", "A", *argv])
    want = [("current", card), ("run", card)]
    if local_rank is not None:
        want = [("join", None), *want, ("leave", None)]
    assert events == want


def test_predict_makes_its_card_current_before_it_runs(monkeypatch, tmp_path):
    from ttl_tpu_torch import predict
    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: events.append(("current", str(d))))

    def fake_predict(cfg, classnames, *, device, **kw):
        events.append(("run", str(device)))
        return 0
    monkeypatch.setattr(predict, "predict_directory", fake_predict)
    predict.main([str(tmp_path), "--test_sets", "A", "--gpu", "3"])
    assert events == [("current", "cuda:3"), ("run", "cuda:3")]


@pytest.mark.parametrize("shape,error", [((2,), ValueError),
                                         ((2, 2), ValueError)])
def test_runner_holds_the_mesh_shape_against_the_world(shape, error):
    cfg = TTLConfig(arch="test-tiny", mesh_shape=shape)
    with pytest.raises(error):
        trunner.run(cfg, device="cpu", datasets={})
