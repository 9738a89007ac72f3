"""The text-side paths of the port against the JAX package, on the CPU.

Same inputs on both sides, made with numpy or bridged from JAX's own
initialisers; everything in f32 at the `test-tiny` size.

- `avg_entropy`, `select_confident` (ties included), `tpt_loss`: values
  within 1e-5 / gradients within 1e-4 (f32 reductions in another order),
  masks and indices equal.
- `PromptLearnerState.assemble` for end / middle / front and learned_cls:
  equal (a gather and a concatenation, no arithmetic).
- `text_features` with adapters (one set, and one set per sample against
  JAX's per-sample calls) and `text_features_from_embeddings` (values and
  gradients, with and without checkpointing) under the per_head, heads and
  einsum routes, the JAX side pinned with `force_mode` (Pallas in interpret
  mode): within 1e-4, the towers' bound in tests/test_torch_clip.py.
- The batched text-LoRA step, TPT on LoRA (image and text mode) and the
  prompt-tuning step against `make_batched_ttl_fn` / `make_tpt_adapt_fn`:
  adapted logits, losses and the adapted ctx within 5e-4, the bound of
  tests/test_torch_adapt.py (forward, backward and AdamW in another order).
- The fused text-LoRA step from uint8 canvases with JAX's own view draws;
  `runner.run` in each of these modes: tests/test_torch_text_runner.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_threads  # noqa: F401  (torch threads per worker)
from test_torch_image import jax_draws, stack_draws

from ttl_tpu.adapt.ttl import make_batched_ttl_fn as j_make_batched
from ttl_tpu.adapt.ttl import make_fused_ttl_fn as j_make_fused
from ttl_tpu.adapt.ttl import make_tpt_adapt_fn as j_make_tpt
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops import entropy as jent
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch.adapt.ttl import (make_batched_ttl_fn, make_fused_ttl_fn,
                                     make_tpt_adapt_fn)
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import prompts as tprompts
from ttl_tpu_torch.models.convert import (adapters_from_numpy,
                                          params_from_numpy,
                                          prompt_learner_from_numpy)
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops import attention as tfa
from ttl_tpu_torch.ops import entropy as tent

S, V, RANK = 2, 8, 4
WINDOW = (2, 3)
CLASSES = ["goldfish", "great white shark", "tree_frog", "box turtle",
           "American alligator", "hen"]
ROUTES = ["per_head", "heads", ""]


# ------------------------------------------------------------------ entropy

def _logits(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_avg_entropy_and_grad_match_jax(masked):
    logits = _logits((16, 7), 0)
    mask = np.arange(16) % 3 == 0 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda x: jent.avg_entropy(x, jmask))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tent.avg_entropy(x, None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)


def test_avg_entropy_batched_rows_are_independent():
    logits = torch.from_numpy(_logits((3, 16, 7), 1))
    mask = torch.from_numpy(np.random.default_rng(2).random((3, 16)) < 0.4)
    batched = tent.tpt_loss(logits, mask)
    assert batched.shape == (3,)
    for i in range(3):
        torch.testing.assert_close(batched[i],
                                   tent.avg_entropy(logits[i], mask[i]))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_select_confident_matches_jax(k):
    logits = _logits((16, 7), 3)
    sel, idx, mask = jent.select_confident(jnp.asarray(logits), k)
    got_sel, got_idx, got_mask = tent.select_confident(
        torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(sel))


def test_select_confident_breaks_ties_like_top_k():
    """Equal entropies: rows 2, 5 and 9 repeat row 0, so four rows tie for
    the lowest entropy and k = 2 must take the two lowest indices."""
    logits = _logits((12, 5), 4)
    logits[0] *= 4.0                      # the most confident row
    for r in (2, 5, 9):
        logits[r] = logits[0]
    _, idx, mask = jent.select_confident(jnp.asarray(logits), 2)
    _, got_idx, got_mask = tent.select_confident(torch.from_numpy(logits), 2)
    assert sorted(np.asarray(idx).tolist()) == [0, 2]
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    # batched: every entry selects on its own
    both = torch.from_numpy(np.stack([logits, logits[::-1].copy()]))
    _, _, masks = tent.select_confident(both, 2)
    assert torch.equal(masks[0], got_mask)
    assert masks[1].sum() == 2


def test_tpt_loss_matches_jax():
    logits = _logits((16, 7), 5)
    _, _, mask = jent.select_confident(jnp.asarray(logits), 4)
    want = float(jent.tpt_loss(jnp.asarray(logits), mask))
    got = tent.tpt_loss(torch.from_numpy(logits),
                        torch.from_numpy(np.asarray(mask)))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def model():
    params = jax.tree.map(np.array, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    adapters0 = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.text.hidden, RANK, "xavier"))
    # a trained-looking B, so the adapters change the features
    rng = np.random.default_rng(6)
    for m in "qv":
        adapters0[m]["B"] = (rng.standard_normal(adapters0[m]["B"].shape)
                             * 0.05).astype(np.float32)
    tokens = np.asarray(jprompts.prompt_tokens(CLASSES))
    views = (rng.standard_normal((S, V, 3, 64, 64)) * 0.6).astype(np.float32)
    return params, adapters0, tokens, views


def _cfg(**kw):
    kw = {"layer_range": WINDOW, **kw}
    return TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                     rank=RANK, compute_dtype="float32",
                     param_dtype="float32", **kw)


def _truncated(tokens):
    return tokens[:, : jprompts.needed_ctx_len(tokens)]


# ------------------------------------------------------------------- prompts

@pytest.mark.parametrize("position,learned_cls", [
    ("end", False), ("middle", False), ("front", False), ("end", True)])
def test_prompt_learner_assemble_matches_jax(model, position, learned_cls):
    params = model[0]
    embed = params["text"]["token_embed"]
    jstate = jprompts.init_prompt_learner(
        jnp.asarray(embed), CLASSES, ctx_position=position,
        learned_cls=learned_cls, key=jax.random.PRNGKey(3))
    # the port's own initialiser builds the same buffers (the learned class
    # vectors are random: JAX's are carried across)
    own = tprompts.init_prompt_learner(
        torch.from_numpy(embed), CLASSES, ctx_position=position,
        learned_cls=learned_cls)
    bridged = prompt_learner_from_numpy(jstate, "cpu")
    for name in ("ctx", "ctx_init", "prefix", "suffix", "tokenized",
                 "name_lens"):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    assert (own.n_ctx, own.prompt_prefix, own.ctx_position) == (
        jstate.n_ctx, jstate.prompt_prefix, jstate.ctx_position)
    assert (own.cls is None) == (jstate.cls is None)
    new_ctx = np.random.default_rng(7).standard_normal(
        np.asarray(jstate.ctx).shape).astype(np.float32)
    want = np.asarray(jstate.assemble(jnp.asarray(new_ctx)))
    got = bridged.assemble(torch.from_numpy(new_ctx))
    np.testing.assert_array_equal(got.numpy(), want)
    # a leading sample axis: every sample assembles with its own ctx
    stacked = torch.from_numpy(np.stack([new_ctx, 2 * new_ctx]))
    both = bridged.assemble(stacked)
    assert both.shape == (2, *want.shape)
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(
        both[1].numpy(), np.asarray(jstate.assemble(jnp.asarray(2 * new_ctx))))
    reset = dataclasses.replace(bridged, ctx=stacked[1]).reset()
    assert torch.equal(reset.ctx, bridged.ctx_init)


def test_init_prompt_learner_refuses_learned_cls_off_the_end():
    with pytest.raises(ValueError, match="learned_cls"):
        tprompts.init_prompt_learner(torch.zeros(49408, 8), CLASSES,
                                     ctx_position="front", learned_cls=True)


# -------------------------------------------------------------------- towers

@pytest.mark.parametrize("route", ROUTES)
def test_text_features_with_adapters_match_jax(model, route):
    params, adapters0, tokens, _ = model
    toks = _truncated(tokens)
    with jfa.force_mode(route):
        want = np.asarray(jclip.text_features(
            params["text"], jnp.asarray(toks), J_TINY.text,
            adapters=adapters0, adapter_window=WINDOW, lora_scale=8.0,
            compute_dtype=jnp.float32))
        plain = np.asarray(jclip.text_features(
            params["text"], jnp.asarray(toks), J_TINY.text,
            compute_dtype=jnp.float32))
    tparams = params_from_numpy(params["text"], "cpu")
    ttoks = torch.from_numpy(toks.astype(np.int64))
    with tfa.force_mode(route):
        got = tclip.text_features(
            tparams, ttoks, TEST_TINY.text,
            adapters=adapters_from_numpy(adapters0, "cpu"),
            adapter_window=WINDOW, lora_scale=8.0,
            compute_dtype=torch.float32)
        got_plain = tclip.text_features(tparams, ttoks, TEST_TINY.text,
                                        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_plain.numpy(), plain, rtol=1e-4, atol=1e-4)
    assert np.abs(want - plain).max() > 1e-3   # the adapters matter


def test_text_features_per_sample_adapters_match_jax(model):
    """[S, L, ...] adapters over [S*C, ctx, D] against one JAX call per
    sample, and their gradients against jax.grad."""
    params, adapters0, tokens, _ = model
    toks = _truncated(tokens)
    sets = [adapters0, jax.tree.map(lambda a: (1.5 * a).astype(np.float32),
                                    adapters0)]

    def jloss(ad):
        return jnp.sum(jnp.sin(jclip.text_features(
            params["text"], jnp.asarray(toks), J_TINY.text, adapters=ad,
            adapter_window=WINDOW, lora_scale=8.0,
            compute_dtype=jnp.float32)))

    with jfa.force_mode("per_head"):
        want = [np.asarray(jclip.text_features(
            params["text"], jnp.asarray(toks), J_TINY.text, adapters=ad,
            adapter_window=WINDOW, lora_scale=8.0,
            compute_dtype=jnp.float32)) for ad in sets]
        want_g = [jax.grad(jloss)(ad) for ad in sets]
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), *sets)
    tad = adapters_from_numpy(stacked, "cpu")
    leaves = [tad[m][ab].requires_grad_(True) for m in "qv" for ab in "AB"]
    with tfa.force_mode("per_head"):
        got = tclip.text_features(
            params_from_numpy(params["text"], "cpu"),
            torch.from_numpy(toks.astype(np.int64)), TEST_TINY.text,
            adapters=tad, adapter_window=WINDOW, lora_scale=8.0,
            compute_dtype=torch.float32)
    assert got.shape == (2 * len(CLASSES), TEST_TINY.text.proj_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.concatenate(want),
                               rtol=1e-4, atol=1e-4)
    torch.sin(got).sum().backward()
    for i, g in enumerate(want_g):
        for m in "qv":
            for ab in "AB":
                np.testing.assert_allclose(
                    tad[m][ab].grad[i].numpy(), np.asarray(g[m][ab]),
                    rtol=2e-3, atol=2e-5, err_msg=f"sample {i} {m}.{ab}")
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("route", ROUTES)
def test_text_features_from_embeddings_match_jax(model, route):
    params, _, tokens, _ = model
    jstate = jprompts.init_prompt_learner(
        jnp.asarray(params["text"]["token_embed"]), CLASSES)
    embs = np.asarray(jstate.assemble())
    toks = np.asarray(jstate.tokenized)

    def jfeats(e):
        return jclip.text_features_from_embeddings(
            params["text"], e, jnp.asarray(toks), J_TINY.text,
            compute_dtype=jnp.float32, remat=True)

    with jfa.force_mode(route):
        want = np.asarray(jfeats(jnp.asarray(embs)))
        want_g = np.asarray(jax.grad(
            lambda e: jnp.sum(jnp.sin(jfeats(e))))(jnp.asarray(embs)))
    tparams = params_from_numpy(params["text"], "cpu")
    ttoks = torch.from_numpy(toks.astype(np.int64))
    grads = {}
    for remat in (False, True):
        e = torch.from_numpy(embs).requires_grad_(True)
        with tfa.force_mode(route):
            got = tclip.text_features_from_embeddings(
                tparams, e, ttoks, TEST_TINY.text,
                compute_dtype=torch.float32, remat=remat)
            torch.sin(got).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(e.grad.numpy(), want_g, rtol=2e-3,
                                   atol=2e-5)
        grads[remat] = e.grad
    # checkpointing recomputes the same operations: equal gradients
    assert torch.equal(grads[False], grads[True])


# --------------------------------------------------------------------- steps

def _jax_lora_step(cfg, params, adapters0, tokens, views, route, text_cls):
    with jfa.force_mode(route):
        fn = j_make_batched(J_TINY, cfg, tokens=jnp.asarray(tokens))
        res = fn(params, jnp.asarray(text_cls), adapters0, jnp.asarray(views),
                 jax.random.split(jax.random.PRNGKey(9), views.shape[0]))
        return jax.tree.map(np.asarray, res)


def _text_cls(n, seed=8):
    cls = np.random.default_rng(seed).standard_normal(
        (n, J_TINY.vision.proj_dim))
    return (cls / np.linalg.norm(cls, axis=-1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("route,tta_steps,deyo", [
    ("per_head", 1, True), ("heads", 2, True), ("", 1, True),
    ("per_head", 1, False), ("", 2, False)])
def test_batched_text_lora_step_matches_jax(model, route, tta_steps, deyo):
    """`--lora_encoder text`, with the DeYO objective (tta_steps**2 updates)
    and with `deyo_selection=False` (TPT on LoRA, tta_steps updates)."""
    params, adapters0, tokens, views = model
    fresh = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.text.hidden, RANK, "xavier"))
    cfg = _cfg(lora_encoder="text", tta_steps=tta_steps, deyo_selection=deyo,
               selection_p=0.4)
    cls = _text_cls(len(CLASSES))
    want = _jax_lora_step(cfg, params, fresh, tokens, views, route, cls)
    with tfa.force_mode(route):
        res = make_batched_ttl_fn(TEST_TINY, cfg, tokens=tokens)(
            params_from_numpy(params, "cpu"), None,
            adapters_from_numpy(fresh, "cpu"), torch.from_numpy(views))
    assert res.losses.shape == (S, tta_steps ** 2 if deyo else tta_steps)
    assert res.logits.shape == (S, len(CLASSES))
    np.testing.assert_allclose(res.losses.numpy(), want.losses, rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(res.logits.numpy(), want.logits, rtol=5e-4,
                               atol=5e-4)
    for m in "qv":
        assert res.adapters[m]["B"].abs().max() > 0   # the step moved them


def test_batched_image_step_with_tpt_objective_matches_jax(model):
    """`deyo_selection=False` in image mode: TPT on the vision LoRA, on the
    default (bshd) route."""
    params, _, tokens, views = model
    fresh = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(2), 2, J_TINY.vision.hidden, RANK, "xavier"))
    cfg = _cfg(deyo_selection=False, tta_steps=2, selection_p=0.4)
    cls = _text_cls(5)
    want = _jax_lora_step(cfg, params, fresh, tokens, views, "bshd", cls)
    res = make_batched_ttl_fn(TEST_TINY, cfg)(
        params_from_numpy(params, "cpu"), torch.from_numpy(cls),
        adapters_from_numpy(fresh, "cpu"), torch.from_numpy(views))
    assert res.losses.shape == (S, 2)
    np.testing.assert_allclose(res.losses.numpy(), want.losses, rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(res.logits.numpy(), want.logits, rtol=5e-4,
                               atol=5e-4)


def test_selection_count_has_a_floor_of_one(model):
    """int(V * selection_p) == 0 still selects one view, as in the JAX
    package, instead of a NaN loss."""
    params, _, tokens, views = model
    fresh = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.text.hidden, RANK, "xavier"))
    cfg = _cfg(lora_encoder="text", deyo_selection=False, selection_p=0.01)
    with tfa.force_mode(""):
        res = make_batched_ttl_fn(TEST_TINY, cfg, tokens=tokens)(
            params_from_numpy(params, "cpu"), None,
            adapters_from_numpy(fresh, "cpu"), torch.from_numpy(views))
    assert torch.isfinite(res.losses).all()
    want = _jax_lora_step(cfg, params, fresh, tokens, views, "",
                          _text_cls(len(CLASSES)))
    np.testing.assert_allclose(res.logits.numpy(), want.logits, rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("route,tta_steps,learned_cls", [
    ("per_head", 1, False), ("heads", 2, False), ("", 1, False),
    ("heads", 1, True)])
def test_tpt_step_matches_jax(model, route, tta_steps, learned_cls):
    """`--lora_encoder prompt`: logits, zero-shot logits, losses and the
    adapted ctx, one JAX call per sample against the port's batch."""
    params, _, _, views = model
    cfg = _cfg(lora_encoder="prompt", tta_steps=tta_steps, selection_p=0.4,
               layer_range=None)
    jstate = jprompts.init_prompt_learner(
        jnp.asarray(params["text"]["token_embed"]), CLASSES,
        learned_cls=learned_cls, key=jax.random.PRNGKey(4))
    with jfa.force_mode(route):
        fn = jax.jit(j_make_tpt(J_TINY, cfg))
        want = [jax.tree.map(np.asarray, fn(
            params, jstate, jnp.asarray(views[i]), jax.random.PRNGKey(i)))
            for i in range(S)]
    with tfa.force_mode(route):
        res, ctx = make_tpt_adapt_fn(TEST_TINY, cfg)(
            params_from_numpy(params, "cpu"),
            prompt_learner_from_numpy(jstate, "cpu"), torch.from_numpy(views))
    assert ctx.shape == (S, *np.asarray(jstate.ctx).shape)
    assert res.losses.shape == (S, tta_steps)
    for i, (jres, jctx) in enumerate(want):
        np.testing.assert_allclose(res.zero_shot_logits[i].numpy(),
                                   jres.zero_shot_logits, rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(res.losses[i].numpy(), jres.losses,
                                   rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(res.logits[i].numpy(), jres.logits,
                                   rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(ctx[i].numpy(), jctx, rtol=5e-4,
                                   atol=5e-4)
        # the tuning moved the ctx: the comparison is not vacuous
        assert np.abs(jctx - np.asarray(jstate.ctx_init)).max() > 1e-3


def test_fused_text_lora_slice_matches_jax(model):
    """From uint8 canvases to adapted logits, given JAX's own view draws,
    under the per_head route."""
    params, _, tokens, _ = model
    fresh = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.text.hidden, RANK, "xavier"))
    cfg = _cfg(lora_encoder="text", seed=5)
    rng = np.random.default_rng(9)
    sizes = [(80, 80), (50, 72)]
    canv = np.zeros((len(sizes), 80, 80, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hs = np.array([h for h, _ in sizes], np.int32)
    ws = np.array([w for _, w in sizes], np.int32)
    idxs = np.array([7, 2], np.int32)
    cls = _text_cls(len(CLASSES))
    with jfa.force_mode("per_head"):
        fn = j_make_fused(J_TINY, cfg, tokens=jnp.asarray(tokens))
        want = np.asarray(fn(params, jnp.asarray(cls), fresh,
                             jnp.asarray(canv), jnp.asarray(hs),
                             jnp.asarray(ws), jnp.asarray(idxs)).logits)
    draws = stack_draws([jax_draws(sample_key(cfg.seed, int(i)), V)
                         for i in idxs])
    with tfa.force_mode("per_head"):
        got = make_fused_ttl_fn(TEST_TINY, cfg, tokens=tokens)(
            params_from_numpy(params, "cpu"), None,
            adapters_from_numpy(fresh, "cpu"), torch.from_numpy(canv),
            torch.from_numpy(hs), torch.from_numpy(ws), draws)
    np.testing.assert_allclose(got.logits.numpy(), want, rtol=5e-4,
                               atol=5e-4)
