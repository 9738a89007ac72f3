"""CoCoOp (`--cocoop`) and `--load` prompt checkpoints of the port against
the JAX package, on the CPU.

Same inputs on both sides, made with numpy or bridged from JAX's own
initialisers; everything in f32 at the `test-tiny` size.

- `init_cocoop`: ctx, prefix, suffix, the token table and n_ctx equal the
  JAX state's (gathers, no arithmetic); the meta-net has torch's Linear
  shapes and bounds (its draws come from another generator, so the values
  are bridged where both sides must agree).
- `meta_shift`: within 1e-6 (two small f32 products).
- `cocoop_state_from_numpy`: leaf by leaf, equal.
- `make_cocoop_adapt_fn` at `tta_steps` 0, 1 and 2, and the fused step from
  uint8 canvases with JAX's own view draws: `logits`, `adapted_logits` and
  `losses` within 5e-4, the bound of tests/test_torch_text.py for the
  prompt-tuning step (forward, backward and AdamW in another order).
- `utils/checkpoint.py`: one file written with `torch.save` loads to the
  same state in both packages.
- `runner.run` with `--cocoop`, `--cocoop --load`, `--tta_steps 0 --cocoop`
  and `--lora_encoder prompt --load` against `ttl_tpu.runner.run` on the same
  arrays, weights and view draws: equal top-1/top-5 and logits within 5e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_threads  # noqa: F401  (torch threads per worker)
from test_torch_image import jax_draws, stack_draws

import ttl_tpu.parallel.eval as jeval
from ttl_tpu import runner as jrunner
from ttl_tpu.adapt import cocoop as jco
from ttl_tpu.adapt.ttl import make_fused_cocoop_fn as j_make_fused_cocoop
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.data.views import ArrayDataset as JArrayDataset
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.utils import checkpoint as jckpt
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt import cocoop as tco
from ttl_tpu_torch.adapt.ttl import make_fused_cocoop_fn
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import prompts as tprompts
from ttl_tpu_torch.models.convert import (cocoop_state_from_numpy,
                                          params_from_numpy)
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.utils import checkpoint as tckpt

S, V = 3, 8
CLASSES = ["goldfish", "great white shark", "tree_frog", "box turtle",
           "American alligator", "hen"]
P_DIM = J_TINY.vision.proj_dim
FLOAT_LEAVES = ("ctx", "meta_w1", "meta_b1", "meta_w2", "meta_b2", "prefix",
                "suffix")


@pytest.fixture(scope="module")
def model():
    params = jax.tree.map(np.array, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    rng = np.random.default_rng(6)
    views = (rng.standard_normal((S, V, 3, 64, 64)) * 0.6).astype(np.float32)
    return params, views


def _live(jstate):
    """At this size the meta-net has one hidden unit, and a drawn bias may
    leave its ReLU at zero for every feature, so that the shift no longer
    depends on the image: a bias of 0.5 keeps the unit live."""
    return dataclasses.replace(jstate,
                               meta_b1=jnp.full_like(jstate.meta_b1, 0.5))


def _jstate(params, key=3, ctx_init="a_photo_of_a"):
    return _live(jco.init_cocoop(
        jnp.asarray(params["text"]["token_embed"]), CLASSES, P_DIM,
        jax.random.PRNGKey(key), ctx_init))


def _cfg(cls=TTLConfig, **kw):
    return cls(arch="test-tiny", resolution=64, batch_size=V, cocoop=True,
               compute_dtype="float32", param_dtype="float32",
               selection_p=0.4, **kw)


# ------------------------------------------------------------------- state

@pytest.mark.parametrize("ctx_init", ["a_photo_of_a", "this_is_a_picture"])
def test_init_cocoop_matches_jax(model, ctx_init):
    params = model[0]
    jstate = _jstate(params, ctx_init=ctx_init)
    own = tco.init_cocoop(torch.from_numpy(params["text"]["token_embed"]),
                          CLASSES, P_DIM, torch.Generator().manual_seed(0),
                          ctx_init)
    assert own.n_ctx == jstate.n_ctx == len(ctx_init.split("_"))
    for name in ("ctx", "prefix", "suffix", "tokenized"):
        got = getattr(own, name)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    assert own.tokenized.dtype == torch.int64
    assert own.tokenized.shape[1] == jprompts.needed_ctx_len(
        np.asarray(jprompts.prompt_tokens(CLASSES,
                                          ctx_init.replace("_", " "))))
    hidden, d = P_DIM // 16, params["text"]["token_embed"].shape[-1]
    # torch's Linear default: U(+-1/sqrt(fan_in)), the bias with its
    # weight's fan-in
    for name, shape, fan_in in (("meta_w1", (P_DIM, hidden), P_DIM),
                                ("meta_b1", (hidden,), P_DIM),
                                ("meta_w2", (hidden, d), hidden),
                                ("meta_b2", (d,), hidden)):
        leaf = getattr(own, name)
        assert leaf.shape == shape == np.asarray(getattr(jstate, name)).shape
        assert leaf.dtype == torch.float32
        assert leaf.abs().max() <= 1.0 / np.sqrt(fan_in)
        assert leaf.abs().max() > 0


def test_init_cocoop_meta_net_depends_only_on_the_generator(model):
    embed = torch.from_numpy(model[0]["text"]["token_embed"])

    def make(seed):
        return tco.init_cocoop(embed, CLASSES, P_DIM,
                               torch.Generator().manual_seed(seed))

    a, b, c = make(1), make(1), make(2)
    for name in ("meta_w1", "meta_b1", "meta_w2", "meta_b2"):
        assert torch.equal(getattr(a, name), getattr(b, name))
        assert not torch.equal(getattr(a, name), getattr(c, name))
    assert torch.equal(a.ctx, c.ctx)


def test_bridge_carries_every_leaf(model):
    jstate = _jstate(model[0])
    state = cocoop_state_from_numpy(jstate, "cpu")
    assert [f.name for f in dataclasses.fields(state)] == [
        f.name for f in dataclasses.fields(jstate)]
    for name in FLOAT_LEAVES:
        leaf = getattr(state, name)
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    assert state.tokenized.dtype == torch.int64
    np.testing.assert_array_equal(state.tokenized.numpy(),
                                  np.asarray(jstate.tokenized))
    assert state.n_ctx == jstate.n_ctx and isinstance(state.n_ctx, int)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_meta_shift_matches_jax(model, lead):
    jstate = _jstate(model[0])
    feats = np.random.default_rng(1).standard_normal(
        (*lead, P_DIM)).astype(np.float32)
    want = np.asarray(jco.meta_shift(
        jstate, jnp.asarray(feats.reshape(-1, P_DIM))))
    got = tco.meta_shift(cocoop_state_from_numpy(jstate, "cpu"),
                         torch.from_numpy(feats))
    assert got.shape == (*lead, jstate.n_ctx, want.shape[-1])
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    # the shift matters: the comparison is not of ctx with itself
    assert np.abs(want - np.asarray(jstate.ctx)).max() > 1e-2


# ------------------------------------------------------------------- steps

@pytest.mark.parametrize("tta_steps", [0, 1, 2])
def test_cocoop_step_matches_jax(model, tta_steps):
    """One JAX call per sample against the port's batch of S."""
    params, views = model
    jstate = _jstate(params)
    with jfa.force_mode("bshd"):
        fn = jax.jit(jco.make_cocoop_adapt_fn(
            J_TINY, _cfg(JTTLConfig, tta_steps=tta_steps)))
        want = [jax.tree.map(np.asarray, fn(
            params, jstate, jnp.asarray(views[i]), jax.random.PRNGKey(i)))
            for i in range(S)]
    res = tco.make_cocoop_adapt_fn(TEST_TINY, _cfg(tta_steps=tta_steps))(
        params_from_numpy(params, "cpu"),
        cocoop_state_from_numpy(jstate, "cpu"), torch.from_numpy(views))
    assert res.logits.shape == res.adapted_logits.shape == (S, len(CLASSES))
    assert res.losses.shape == (S, tta_steps)
    assert not res.logits.requires_grad
    for i, jres in enumerate(want):
        np.testing.assert_allclose(res.logits[i].numpy(), jres.logits,
                                   rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(res.adapted_logits[i].numpy(),
                                   jres.adapted_logits, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(res.losses[i].numpy(), jres.losses,
                                   rtol=5e-4, atol=5e-4)
        # `logits` (clean view's own ctx) and `adapted_logits` (the mean
        # feature's ctx, tuned) are different predictions on both sides
        assert np.abs(jres.logits - jres.adapted_logits).max() > 1e-3


def test_cocoop_step_at_zero_steps_classifies_with_the_mean_feature_ctx(
        model):
    """`--tta_steps 0`: no update, so `adapted_logits` are the clean view's
    logits under pgen_ctx0, the shift from the mean of the views' normalised
    features."""
    params, views = model
    tparams = params_from_numpy(params, "cpu")
    state = cocoop_state_from_numpy(_jstate(params), "cpu")
    res = tco.make_cocoop_adapt_fn(TEST_TINY, _cfg(tta_steps=0))(
        tparams, state, torch.from_numpy(views))
    with torch.no_grad():
        vf = tclip.l2_normalize(tclip.encode_image(
            tparams["vision"], torch.from_numpy(views).flatten(0, 1),
            TEST_TINY.vision, compute_dtype=torch.float32)).unflatten(
                0, (S, V))
        ctx = tco.meta_shift(state, vf.mean(dim=1))
        for i in range(S):
            embs = torch.cat([state.prefix,
                              ctx[i].expand(len(CLASSES), *ctx[i].shape),
                              state.suffix], dim=1)
            txt = tclip.l2_normalize(tclip.text_features_from_embeddings(
                tparams["text"], embs, state.tokenized, TEST_TINY.text,
                compute_dtype=torch.float32))
            want = torch.exp(tparams["logit_scale"]) * vf[i, 0] @ txt.T
            torch.testing.assert_close(res.adapted_logits[i], want,
                                       rtol=1e-4, atol=1e-4)


def test_fused_cocoop_matches_jax(model):
    """From uint8 canvases to the three results for S = 3, given JAX's own
    view draws."""
    params, _ = model
    jstate = _jstate(params)
    cfg_kw = dict(tta_steps=1, seed=5)
    rng = np.random.default_rng(9)
    sizes = [(80, 80), (50, 72), (64, 30)]
    canv = np.zeros((len(sizes), 80, 80, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hs = np.array([h for h, _ in sizes], np.int32)
    ws = np.array([w for _, w in sizes], np.int32)
    idxs = np.array([11, 4, 27], np.int32)
    with jfa.force_mode("bshd"):
        fn = j_make_fused_cocoop(J_TINY, _cfg(JTTLConfig, **cfg_kw))
        want = jax.tree.map(np.asarray, fn(
            params, jstate, jnp.asarray(canv), jnp.asarray(hs),
            jnp.asarray(ws), jnp.asarray(idxs)))
    draws = stack_draws([jax_draws(sample_key(5, int(i)), V) for i in idxs])
    got = make_fused_cocoop_fn(TEST_TINY, _cfg(**cfg_kw))(
        params_from_numpy(params, "cpu"),
        cocoop_state_from_numpy(jstate, "cpu"), torch.from_numpy(canv),
        torch.from_numpy(hs), torch.from_numpy(ws), draws)
    for name in ("logits", "adapted_logits", "losses"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_cocoop_vision_tower_takes_the_fused_route(model, monkeypatch):
    """The step's vision tower is frozen: four fused layernorm + linear
    calls a layer over all S*V views at once, none from the text tower."""
    params, views = model
    shapes = []
    real = tclip.ln_matmul

    def counting(x, *args):
        shapes.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(tclip, "ln_matmul", counting)
    tco.make_cocoop_adapt_fn(TEST_TINY, _cfg(tta_steps=1))(
        params_from_numpy(params, "cpu"),
        cocoop_state_from_numpy(_jstate(params), "cpu"),
        torch.from_numpy(views))
    assert len(shapes) == 4 * TEST_TINY.vision.layers
    assert set(shapes) == {(S * V, 32, TEST_TINY.vision.hidden)}


# -------------------------------------------------------------- checkpoints

def _ckpt_tensors(n_ctx, d, seed=2):
    g = torch.Generator().manual_seed(seed)
    hidden = P_DIM // 16
    return {
        "prompt_learner.ctx": torch.randn(n_ctx, d, generator=g) * 0.1,
        "prompt_learner.meta_net.linear1.weight":
            torch.randn(hidden, P_DIM, generator=g) * 0.3,
        "prompt_learner.meta_net.linear1.bias":
            torch.randn(hidden, generator=g) * 0.1,
        "prompt_learner.meta_net.linear2.weight":
            torch.randn(d, hidden, generator=g) * 0.3,
        "prompt_learner.meta_net.linear2.bias":
            torch.randn(d, generator=g) * 0.1,
        # the fixed buffers of another class list: dropped on load
        "prompt_learner.token_prefix": torch.zeros(7, 1, d),
        "prompt_learner.token_suffix": torch.zeros(7, 72, d),
    }


def _write_ckpt(path, tensors, wrapped):
    # keys as a trained checkpoint has them, with and without the wrapper
    sd = {k.replace("prompt_learner.token_", "token_"): v
          for k, v in tensors.items()}
    torch.save({"state_dict": sd, "epoch": 10} if wrapped else sd, path)
    return str(path)


@pytest.mark.parametrize("wrapped", [True, False])
def test_cocoop_checkpoint_loads_as_in_jax(model, tmp_path, capsys, wrapped):
    params = model[0]
    jstate = _jstate(params)
    d = params["text"]["token_embed"].shape[-1]
    path = _write_ckpt(tmp_path / "cocoop.pth",
                       _ckpt_tensors(jstate.n_ctx, d), wrapped)
    jsd = jckpt.load_prompt_state_dict(path)
    jtext = capsys.readouterr().out
    sd = tckpt.load_prompt_state_dict(path)
    assert capsys.readouterr().out == jtext   # the reference's two lines
    assert f"(epoch {10 if wrapped else '?'})" in jtext
    assert sorted(sd) == sorted(jsd)
    assert not any("token_" in k for k in sd)
    for k in sd:
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)
    want = jckpt.apply_cocoop_ckpt(jstate, jsd)
    got = tckpt.apply_cocoop_ckpt(cocoop_state_from_numpy(jstate, "cpu"), sd)
    for name in FLOAT_LEAVES + ("tokenized",):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # [out, in] in the file, [in, out] in the state
    assert got.meta_w1.shape == (P_DIM, P_DIM // 16)
    assert got.meta_w1.is_contiguous()
    assert not np.array_equal(got.meta_w1.numpy(), np.asarray(jstate.meta_w1))


@pytest.mark.parametrize("wrapped", [True, False])
def test_coop_checkpoint_loads_as_in_jax(model, tmp_path, wrapped):
    """A CoOp checkpoint gives the prompt learner its ctx and the snapshot
    that every sample's tuning starts from."""
    params = model[0]
    embed = params["text"]["token_embed"]
    jstate = jprompts.init_prompt_learner(jnp.asarray(embed), CLASSES)
    tensors = {k: v for k, v in _ckpt_tensors(jstate.n_ctx,
                                              embed.shape[-1]).items()
               if "meta_net" not in k}
    path = _write_ckpt(tmp_path / "coop.pth", tensors, wrapped)
    want = jckpt.apply_prompt_ckpt(jstate, jckpt.load_prompt_state_dict(path))
    state = tprompts.init_prompt_learner(torch.from_numpy(embed), CLASSES)
    got = tckpt.apply_prompt_ckpt(state, tckpt.load_prompt_state_dict(path))
    for name in ("ctx", "ctx_init"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
        assert not torch.equal(getattr(got, name), getattr(state, name))
    np.testing.assert_array_equal(got.assemble().numpy(),
                                  np.asarray(want.assemble()))
    # a file without a ctx leaves the state as it was
    assert tckpt.apply_prompt_ckpt(state, {"other": torch.zeros(1)}) is state


def test_missing_checkpoint_gives_none(tmp_path, capsys):
    path = str(tmp_path / "nothing.pth")
    assert jckpt.load_prompt_state_dict(path) is None
    jtext = capsys.readouterr().out
    assert tckpt.load_prompt_state_dict(path) is None
    assert capsys.readouterr().out == jtext
    assert "no checkpoint found" in jtext


# ------------------------------------------------------------------ runner

N_IMAGES, SAMPLE_BATCH = 5, 2


def _run_both(monkeypatch, tmp_path, mode, ckpt_kind=None):
    """`ttl_tpu.runner.run` and the port's `runner.run` on the same images,
    the JAX runner's weights and meta-net bridged across and its view draws
    handed to the port; returns ((top1, top5), logits by label) of each."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (N_IMAGES, 40, 56, 3), dtype=np.uint8)
    labels = np.array([3, 1, 4, 7, 5])
    kw = dict(arch="test-tiny", resolution=64, batch_size=V,
              sample_batch=SAMPLE_BATCH, compute_dtype="float32",
              param_dtype="float32", workers=1, selection_p=0.4,
              test_sets="cifar10", seed=3, **mode)
    if ckpt_kind:
        tensors = _ckpt_tensors(4, J_TINY.text.hidden)
        if ckpt_kind == "coop":
            tensors = {k: v for k, v in tensors.items()
                       if "meta_net" not in k}
        kw["load"] = _write_ckpt(tmp_path / "prompt.pth", tensors, True)
    jcfg, cfg = JTTLConfig(**kw), TTLConfig(**kw)

    # --- the JAX runner, its logits recorded where it counts the hits
    seen = {"jax": [], "port": []}
    real_make_count = jeval.make_count_fn

    def recording_make_count(mesh=None):
        count = real_make_count(mesh)

        def count_and_record(logits, lab, valid):
            seen["jax"].append((np.asarray(logits), np.asarray(lab),
                                np.asarray(valid)))
            return count(logits, lab, valid)
        return count_and_record

    monkeypatch.setattr(jeval, "make_count_fn", recording_make_count)
    real_init = jco.init_cocoop

    def live_init_cocoop(*args):
        return _live(real_init(*args))

    monkeypatch.setattr(jco, "init_cocoop", live_init_cocoop)
    _, jparams = jrunner.load_model(jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    with jfa.force_mode("bshd"):
        want = jrunner.run(jcfg, datasets={
            "cifar10": JArrayDataset(images, labels)})["cifar10"]

    # --- the port, on those weights, that meta-net and those draws
    monkeypatch.setattr(
        trunner, "load_model",
        lambda c, device: (TEST_TINY, params_from_numpy(jparams, device)))
    monkeypatch.setattr(
        trunner, "draw_batch",
        lambda seed, indices, n: stack_draws(
            [jax_draws(sample_key(seed, int(i)), n) for i in indices]))
    monkeypatch.setattr(
        trunner, "init_cocoop",
        lambda embed, names, proj_dim, generator, ctx_init:
        cocoop_state_from_numpy(live_init_cocoop(
            jnp.asarray(embed.numpy()), names, proj_dim,
            jax.random.PRNGKey(cfg.seed), ctx_init), "cpu"))
    real_topk = trunner.topk_counts

    def topk_and_record(logits, lab, valid):
        seen["port"].append((logits.numpy(), lab.numpy(), valid.numpy()))
        return real_topk(logits, lab, valid)

    monkeypatch.setattr(trunner, "topk_counts", topk_and_record)
    got = trunner.run(cfg, device="cpu", datasets={
        "cifar10": ArrayDataset(images, labels)})["cifar10"]

    def by_label(batches):
        rows = {}
        for logits, lab, valid in batches:
            for row, y, ok in zip(logits, lab, valid):
                if ok:
                    rows[int(y)] = row
        return rows

    return want, got, by_label(seen["jax"]), by_label(seen["port"])


@pytest.mark.parametrize("mode,ckpt_kind", [
    ({"cocoop": True}, None),
    ({"cocoop": True}, "cocoop"),
    ({"cocoop": True, "tta_steps": 0}, None),
    ({"lora_encoder": "prompt"}, "coop"),
    ({"lora_encoder": "prompt", "tta_steps": 0}, "coop"),
], ids=["cocoop", "cocoop-load", "cocoop-steps0", "prompt-load",
        "prompt-steps0-load"])
def test_runner_matches_jax_runner(monkeypatch, tmp_path, mode, ckpt_kind):
    want, got, jrows, rows = _run_both(monkeypatch, tmp_path, mode, ckpt_kind)
    assert sorted(rows) == sorted(jrows) == [1, 3, 4, 5, 7]
    for y in rows:
        np.testing.assert_allclose(rows[y], jrows[y], rtol=5e-4, atol=5e-4,
                                   err_msg=f"label {y}")
    assert got == pytest.approx(want)
    assert 0.0 <= got[0] <= got[1] <= 100.0


def test_checkpoint_changes_the_cocoop_logits(monkeypatch, tmp_path):
    """`--load` is not ignored: the run with a checkpoint and the run
    without give different logits on the same images."""
    _, _, _, plain = _run_both(monkeypatch, tmp_path, {"cocoop": True})
    _, _, _, loaded = _run_both(monkeypatch, tmp_path, {"cocoop": True},
                                "cocoop")
    assert max(np.abs(plain[y] - loaded[y]).max() for y in plain) > 1e-2


def test_runner_cocoop_with_whole_int8_tower_makes_no_fused_call(
        monkeypatch):
    """`--cocoop --prefix_quant int8` quantises the whole frozen tower: its
    layers run the int8 linears and the fused layernorm + linear is reached
    0 times."""
    calls = []
    real = tclip.ln_matmul
    monkeypatch.setattr(tclip, "ln_matmul",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8),
                      np.array([3, 1, 4]))
    kw = dict(arch="test-tiny", resolution=64, batch_size=V, sample_batch=2,
              compute_dtype="float32", param_dtype="float32", workers=1,
              cocoop=True, test_sets="cifar10")
    top1, top5 = trunner.run(TTLConfig(prefix_quant="int8", **kw),
                             device="cpu", datasets={"cifar10": ds})["cifar10"]
    assert 0.0 <= top1 <= top5 <= 100.0
    assert calls == []
    trunner.run(TTLConfig(**kw), device="cpu", datasets={"cifar10": ds})
    assert len(calls) == 2 * 4 * TEST_TINY.vision.layers   # two batches


def test_cli_flags_reach_the_cocoop_run(tmp_path, capsys):
    """`--cocoop --load FILE` from the command line: a missing file prints
    the reference's line and the run goes on with the drawn meta-net."""
    missing = str(tmp_path / "none.pth")
    args = tcli.build_parser().parse_args(
        ["data", "--test_sets", "cifar10", "--cocoop", "--load", missing,
         "-a", "test-tiny", "--resolution", "64", "-b", str(V),
         "--sample_batch", "2", "--workers", "1"])
    cfg = dataclasses.replace(tcli.config_from_args(args),
                              compute_dtype="float32", param_dtype="float32")
    assert cfg.cocoop and cfg.load == missing
    rng = np.random.default_rng(1)
    ds = ArrayDataset(rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
                      np.array([2, 9]))
    res = trunner.run(cfg, device="cpu", datasets={"cifar10": ds})
    assert 0.0 <= res["cifar10"][0] <= res["cifar10"][1] <= 100.0
    assert f"=> no checkpoint found at '{missing}'" in capsys.readouterr().out
