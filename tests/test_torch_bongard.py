"""The Bongard-HOI set of the port against the JAX package, on the CPU.

Same inputs on both sides: episodes written as JPEG files from a numpy
seed, JAX's weights and adapters bridged across (`params_from_numpy`,
`adapters_from_numpy`), and JAX's own view draws of each query's key handed
to the port's `runner.draw_batch`. Everything in f32 at the `test-tiny`
size. Tolerance: 1e-5 relative (and 1e-6 absolute) at f32, for the support
features, the prototypes' logits and the adapted queries' logits alike.

- `data/bongard.py`: the episodes (paths, labels, order) equal JAX's.
- `make_support_encoder`: the support features.
- The batched step with a classifier per sample ([S, 2, P]) against JAX's
  `make_bongard_step_fn` on two queries with different prototypes; the
  [C, P] classifier and the same table repeated as [S, C, P] agree.
- `evaluate_bongard`, adapted and at `--tta_steps 0`: every episode's
  support features and query logits, and the accuracy.
- `runner.run` with `--test_sets bongard` against `ttl_tpu.runner.run`.
- The ValueError of `--lora_encoder text`.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
import test_torch_threads  # noqa: F401  (torch threads per worker)
from test_torch_image import jax_draws, stack_draws

from ttl_tpu import runner as jrunner
from ttl_tpu.adapt import bongard as jbongard
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.data.bongard import BongardDataset as JBongardDataset
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt import bongard as tbongard
from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.bongard import BongardDataset
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY

RTOL, ATOL = 1e-5, 1e-6
KW = dict(arch="test-tiny", resolution=64, batch_size=8, layer_range=(2, 3),
          rank=4, test_sets="bongard", compute_dtype="float32",
          param_dtype="float32", sample_batch=2, print_freq=1000)
CFG = TTLConfig(**KW)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Three episodes of visually separable concepts (red-ish against
    blue-ish), as tests/test_bongard_eval.py builds them; the split file
    and the pictures of both packages' datasets."""
    root = tmp_path_factory.mktemp("bongard")
    splits = root / "splits"
    splits.mkdir()
    rng = np.random.RandomState(0)

    def save(name, hue):
        img = (rng.rand(72, 80, 3) * 80).astype(np.uint8)
        img[..., hue] = np.minimum(255, img[..., hue] + 160)
        Image.fromarray(img).save(root / name)
        return f"./{name}"

    tasks = []
    for t in range(3):
        pos = [{"im_path": save(f"t{t}_pos_{i}.jpg", 0)} for i in range(7)]
        neg = [{"im_path": save(f"t{t}_neg_{i}.jpg", 2)} for i in range(7)]
        tasks.append([neg, pos, "hold++cup"])
    (splits / "bongard_hoi_test_unseen_obj_unseen_act.json").write_text(
        json.dumps(tasks))
    return (BongardDataset(str(root), mode="test", splits_dir=str(splits)),
            JBongardDataset(str(root), mode="test", splits_dir=str(splits)))


@pytest.fixture(scope="module")
def model():
    """JAX's weights and adapters as numpy trees (the JAX runner's own)."""
    jcfg = JTTLConfig(**KW)
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    adapters0 = jax.tree.map(np.array, jrunner.make_adapters0(jcfg, J_TINY))
    return params, adapters0


@pytest.fixture
def jax_view_draws(monkeypatch):
    """The port's view draws of dataset index i: JAX's of sample_key(seed,
    i)."""
    monkeypatch.setattr(
        trunner, "draw_batch",
        lambda seed, indices, n: stack_draws(
            [jax_draws(sample_key(seed, int(i)), n) for i in indices]))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_episodes_equal_jax(episodes):
    port, ref = episodes
    assert len(port) == len(ref) == 3
    for i in range(3):
        assert dataclasses.asdict(port[i]) == dataclasses.asdict(ref[i])
    ep = port[0]
    assert ep.support_labels == [0] * 6 + [1] * 6
    assert ep.query_labels == [1, 0]


def _canvases(paths):
    from ttl_tpu_torch.data.views import load_canvas
    canv = np.zeros((len(paths), 512, 512, 3), np.uint8)
    hs = np.zeros((len(paths),), np.int32)
    ws = np.zeros((len(paths),), np.int32)
    for k, p in enumerate(paths):
        canv[k], hs[k], ws[k] = load_canvas(p, 512)
    return canv, hs, ws


def test_support_features_match_jax(episodes, model):
    params, _ = model
    ep = episodes[0][1]
    canv, hs, ws = _canvases(ep.support_paths)
    want = np.asarray(jbongard.make_support_encoder(J_TINY, CFG)(
        params, jnp.asarray(canv), jnp.asarray(hs), jnp.asarray(ws)))
    got = tbongard.make_support_encoder(TEST_TINY, CFG)(
        params_from_numpy(params, "cpu"), *map(torch.from_numpy,
                                               (canv, hs, ws)))
    assert got.shape == (12, J_TINY.vision.proj_dim)
    _close(got.numpy(), want)


def _protos(seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((2, 2, J_TINY.vision.proj_dim))
    return (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)


def test_per_sample_classifier_step_matches_jax(episodes, model,
                                                jax_view_draws):
    """Two queries, each with its own [2, P] table."""
    params, adapters0 = model
    ep = episodes[0][1]
    canv, hs, ws = _canvases(ep.query_paths)
    protos = _protos(1)
    assert np.abs(protos[0] - protos[1]).max() > 0.1
    idxs = np.array([6, 7], np.int32)
    with jfa.force_mode("bshd"):
        want = jbongard.make_bongard_step_fn(J_TINY, CFG)(
            params, jnp.asarray(protos), adapters0, jnp.asarray(canv),
            jnp.asarray(hs), jnp.asarray(ws), jnp.asarray(idxs))
    got = tbongard.make_bongard_step_fn(TEST_TINY, CFG)(
        params_from_numpy(params, "cpu"), torch.from_numpy(protos),
        adapters_from_numpy(adapters0, "cpu"),
        *map(torch.from_numpy, (canv, hs, ws)),
        trunner.sample_draws(CFG, idxs))
    assert got.logits.shape == (2, 2)
    _close(got.logits.numpy(), np.asarray(want.logits))
    _close(got.losses.numpy(), np.asarray(want.losses))


def test_shared_and_repeated_classifier_agree(model):
    """[C, P] shared, and the same table repeated as [S, C, P]: the
    adapted logits, the losses and the zero-shot logits agree within the
    f32 tolerance. Not bit for bit: the two routes take two products of
    other shapes ([S*V', P] x [P, C] against S of [V', P] x [P, C]), and a
    CPU GEMM may sum a row in another order at another shape."""
    params, adapters0 = model
    rng = np.random.default_rng(2)
    views = torch.from_numpy(
        (rng.standard_normal((3, 8, 3, 64, 64)) * 0.6).astype(np.float32))
    table = torch.from_numpy(_protos(3)[0])
    step = make_batched_ttl_fn(TEST_TINY, CFG, zero_shot_aux=True)
    args = (params_from_numpy(params, "cpu"),)
    ad = adapters_from_numpy(adapters0, "cpu")
    shared = step(*args, table, ad, views)
    repeated = step(*args, table.expand(3, *table.shape), ad, views)
    for name in ("logits", "losses", "zero_shot_logits"):
        _close(getattr(repeated, name).numpy(), getattr(shared, name).numpy())
    assert torch.equal(repeated.logits.argmax(-1), shared.logits.argmax(-1))


def _evaluate_both(monkeypatch, episodes, model, tta_steps):
    """evaluate_bongard of both packages over the episodes, each side's
    support features and query logits recorded."""
    params, adapters0 = model
    seen = {"jax": [], "port": []}

    def recording(module, side, name, to_np):
        make = getattr(module, name)

        def factory(clip_cfg, cfg):
            fn = make(clip_cfg, cfg)

            def run(*args):
                out = fn(*args)
                seen[side].append(to_np(getattr(out, "logits", out)))
                return out
            return run
        monkeypatch.setattr(module, name, factory)

    for name in ("make_support_encoder", "make_bongard_step_fn"):
        recording(jbongard, "jax", name, np.asarray)
        recording(tbongard, "port", name, lambda t: t.numpy())
    cfg = CFG if tta_steps else dataclasses.replace(CFG, tta_steps=0)
    with jfa.force_mode("bshd"):
        want = jbongard.evaluate_bongard(
            JTTLConfig(**dataclasses.asdict(cfg)), episodes[1], J_TINY,
            params, adapters0)
    got = tbongard.evaluate_bongard(
        cfg, episodes[0], TEST_TINY, params_from_numpy(params, "cpu"),
        adapters_from_numpy(adapters0, "cpu"), device="cpu")
    return want, got, seen


@pytest.mark.parametrize("tta_steps", [1, 0])
def test_evaluate_bongard_matches_jax(monkeypatch, episodes, model,
                                      jax_view_draws, tta_steps):
    want, got, seen = _evaluate_both(monkeypatch, episodes, model, tta_steps)
    # per episode: the support features, then the queries' adapted logits
    # (or their center features)
    assert len(seen["port"]) == len(seen["jax"]) == 6
    for g, w in zip(seen["port"], seen["jax"]):
        _close(g, w)
    assert got == want
    assert 0.0 <= got <= 100.0


def test_runner_matches_jax(monkeypatch, episodes, model, jax_view_draws,
                            capsys):
    params, adapters0 = model
    monkeypatch.setattr(trunner, "load_model", lambda c, device: (
        TEST_TINY, params_from_numpy(params, device)))
    monkeypatch.setattr(trunner, "make_adapters0", lambda c, clip, device:
                        adapters_from_numpy(adapters0, device))
    got = trunner.run(CFG, device="cpu",
                      datasets={"bongard": episodes[0]})["bongard"]
    assert "=> Acc. on testset [bongard]" in capsys.readouterr().out
    monkeypatch.setattr(jrunner, "load_model", lambda c: (J_TINY, params))
    with jfa.force_mode("bshd"):
        want = jrunner.run(JTTLConfig(**KW),
                           datasets={"bongard": episodes[1]})["bongard"]
    assert got == want
    assert got[1] == 100.0  # the 2-way task: top-5 is trivial


def test_text_mode_raises_the_jax_value_error(episodes, model):
    params, _ = model
    cfg = dataclasses.replace(CFG, lora_encoder="text")
    with pytest.raises(ValueError, match="lora_encoder='text'") as got:
        tbongard.evaluate_bongard(cfg, episodes[0], TEST_TINY,
                                  params_from_numpy(params, "cpu"), None,
                                  device="cpu")
    with pytest.raises(ValueError) as want:
        jbongard.evaluate_bongard(JTTLConfig(**dataclasses.asdict(cfg)),
                                  episodes[1], J_TINY, params, None)
    assert str(got.value) == str(want.value)
    # and the batched step refuses a classifier per sample in text mode
    step = make_batched_ttl_fn(TEST_TINY, cfg, tokens=np.ones((2, 77),
                                                              np.int64))
    with pytest.raises(ValueError, match="per sample"):
        step(params_from_numpy(params, "cpu"),
             torch.from_numpy(_protos(4)), None,
             torch.zeros(2, 8, 3, 64, 64))
