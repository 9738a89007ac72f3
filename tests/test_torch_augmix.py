"""AugMix in the port (`ops/augmix.py`, the mix in `ops/image.py`) against
`ttl_tpu.ops.augmix` and `ttl_tpu.ops.image.make_view_fn`.

The JAX ops draw their levels and signs inside from a key; the port takes
them as input. `jax_chain_draws` and `jax_aug_draws` replay JAX's own draws
from the key splits of `make_augmix_chain` and `make_view_fn`'s
`one_view`, so both sides apply the same ops with the same levels.

Tolerances, f32 in [0, 1] units: the pointwise ops 1e-6. The geometric ops
1e-4: XLA fuses the source coordinates a x + b y + c into multiply-adds, so
a coordinate near 224 lies an f32 step (1.5e-5) off the port's, and a
bilinear sample moves by that times its neighbours' difference (at most 1).
Chains and whole views: posterize, solarize and equalize step at
thresholds, so an input an f32 rounding away from one (after a geometric op
or the crop's resize, which sum in another order) lands a step away; at
most 1 % of the values may differ by more than 1e-4 (measured: 0.05 % of a
224-pixel view), and every other value lies within 1e-4. One fused step of
TPT and of CoCoOp with AugMix views: 5e-4, the bound of their steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttl_tpu.adapt import cocoop as jco
from ttl_tpu.adapt import ttl as jttl
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.models import clip as jclip
from ttl_tpu.models import prompts as jprompts
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops import augmix as jaug
from ttl_tpu.ops.image import make_view_fn
from ttl_tpu_torch.adapt import ttl as tttl
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models.convert import (cocoop_state_from_numpy,
                                          params_from_numpy,
                                          prompt_learner_from_numpy)
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops import attention as tfa
from ttl_tpu_torch.ops import augmix as taug
from ttl_tpu_torch.ops import image as timg

from test_torch_image import jax_draws, stack_draws

SEV = 3
GEOMETRIC = {"rotate", "shear_x", "shear_y", "translate_x", "translate_y"}
POINTWISE_BOUND, GEOMETRIC_BOUND = 1e-6, 1e-4
STEP_SHARE = 1e-2


def jax_op_draw(name, key, severity=SEV):
    """(level, sign) that JAX's op `name` draws from `key`."""
    if name in GEOMETRIC:
        k1, k2 = jax.random.split(key)
        return (float(jax.random.uniform(k1, minval=0.1,
                                         maxval=float(severity))),
                bool(jax.random.bernoulli(k2)))
    return float(jax.random.uniform(key, minval=0.1,
                                    maxval=float(severity))), False


def jax_chain_draws(key, aug_ops, severity=SEV):
    """(depth, op [3], level [3], sign [3]) of `make_augmix_chain`'s chain
    for `key`: a level and sign for every slot, as each op reads them."""
    k_depth, k_ops, k_apply = jax.random.split(key, 3)
    depth = int(jax.random.randint(k_depth, (), 1, 4))
    ops = np.asarray(jax.random.randint(k_ops, (3,), 0, len(aug_ops)))
    level, sign = zip(*[jax_op_draw(aug_ops[int(o)], k, severity)
                        for o, k in zip(ops, jax.random.split(k_apply, 3))])
    return depth, ops.astype(np.int64), np.float32(level), np.bool_(sign)


def jax_aug_draws(key, n_views, aug_ops, severity=SEV) -> dict:
    """The AugMix draws `make_view_fn(n_views, aug_ops=...)` consumes for
    `key`, in the port's layout ([n-1, ...])."""
    out = {k: [] for k in ("mix_w", "mix_m", "depth", "op", "level", "sign")}
    for k in jax.random.split(key, n_views - 1):
        kw, km, kc = jax.random.split(jax.random.split(k, 3)[2], 3)
        out["mix_w"].append(np.asarray(jax.random.dirichlet(kw,
                                                            jnp.ones((3,)))))
        out["mix_m"].append(np.asarray(jax.random.uniform(km)))
        chains = [jax_chain_draws(ck, aug_ops, severity)
                  for ck in jax.random.split(kc, 3)]
        for i, name in enumerate(("depth", "op", "level", "sign")):
            out[name].append(np.stack([c[i] for c in chains]))
    return {k: np.stack(v) for k, v in out.items()}


def _images() -> np.ndarray:
    """[4, 224, 224, 3] in [0, 1]: noise, a smooth ramp, a constant image,
    and one of a few grey levels (equalize's sparse histogram)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:224, 0:224] / 224.0
    few = rng.integers(0, 6, (224, 224, 1)) * 0.1 + np.zeros((1, 1, 3))
    return np.stack([rng.uniform(0, 1, (224, 224, 3)),
                     np.stack([yy, xx, (yy + xx) / 2], -1),
                     np.full((224, 224, 3), 0.4), few]).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", jaug.AUG_NAMES)
def test_op_matches_jax(name):
    imgs = _images()
    keys = jax.random.split(jax.random.PRNGKey(1), len(imgs))
    op = jax.jit(lambda im, k: jaug.OPS[name](im, k, SEV))
    want = np.stack([np.asarray(op(im, k)) for im, k in zip(imgs, keys)])
    level, sign = zip(*[jax_op_draw(name, k) for k in keys])
    got = taug.OPS[name](_nchw(imgs), torch.tensor(level),
                         torch.tensor(sign)).permute(0, 2, 3, 1).numpy()
    bound = GEOMETRIC_BOUND if name in GEOMETRIC else POINTWISE_BOUND
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _step_diff(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got - want)
    assert (diff > GEOMETRIC_BOUND).mean() <= STEP_SHARE
    assert np.median(diff) <= POINTWISE_BOUND


def test_chain_matches_jax():
    """Eight chains over DEFAULT_AUG_LIST on the noise and ramp images:
    depths and ops as JAX's keys pick them."""
    aug = jaug.DEFAULT_AUG_LIST
    imgs = _images()[[0, 1] * 4]
    keys = jax.random.split(jax.random.PRNGKey(2), len(imgs))
    chain = jax.jit(jaug.make_augmix_chain(aug, SEV, 224))
    want = np.stack([np.asarray(chain(im, k)) for im, k in zip(imgs, keys)])
    depth, ops, level, sign = (torch.from_numpy(np.stack(d)) for d in zip(
        *[jax_chain_draws(k, aug) for k in keys]))
    assert set(depth.tolist()) == {1, 2, 3}
    got = taug.apply_chains(_nchw(imgs), depth, ops, level, sign,
                            aug).permute(0, 2, 3, 1).numpy()
    _step_diff(got, want)
    assert np.abs(got - imgs).max() > 0.1


def test_view_maker_with_augmix_matches_jax():
    """`render_views` with aug_ops against `make_view_fn(aug_ops=...)` on
    two canvases, JAX's view and AugMix draws bridged; compared in [0, 1]
    units (normalized difference times the CLIP std)."""
    aug, n_views, out = jaug.DEFAULT_AUG_LIST, 5, 96
    rng = np.random.default_rng(3)
    sizes = [(120, 96), (80, 128)]
    canv = np.zeros((2, 128, 128, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    view_fn = jax.jit(make_view_fn(n_views, out, aug_ops=aug, severity=SEV,
                                   out_dtype=jnp.float32))
    want = np.stack([np.asarray(view_fn(jnp.asarray(canv[i]), h, w, keys[i]))
                     for i, (h, w) in enumerate(sizes)])
    draws = stack_draws([{**jax_draws(k, n_views),
                          **jax_aug_draws(k, n_views, aug)} for k in keys])
    got = timg.render_views(
        torch.from_numpy(canv), torch.tensor([h for h, _ in sizes]),
        torch.tensor([w for _, w in sizes]), draws, out_size=out,
        out_dtype=torch.float32, aug_ops=aug).numpy()
    std = np.asarray(timg.CLIP_STD, np.float32)[:, None, None]
    _step_diff(got * std, want * std)
    plain = timg.render_views(
        torch.from_numpy(canv), torch.tensor([h for h, _ in sizes]),
        torch.tensor([w for _, w in sizes]), draws, out_size=out,
        out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got[:, 0], plain[:, 0])  # center unmixed
    assert np.abs(got[:, 1:] - plain[:, 1:]).max() > 0.1


def test_augmix_draws():
    plain = timg.draw_view_params(0, 7, 6)
    d = timg.draw_view_params(0, 7, 6, n_aug_ops=9, severity=SEV)
    for k in plain:   # the view draws come first and stay as they were
        assert torch.equal(d[k], plain[k])
    assert d["mix_w"].shape == (5, 3) and d["op"].shape == (5, 3, 3)
    torch.testing.assert_close(d["mix_w"].sum(-1), torch.ones(5))
    assert ((d["mix_m"] >= 0) & (d["mix_m"] < 1)).all()
    assert ((d["depth"] >= 1) & (d["depth"] <= 3)).all()
    assert ((d["op"] >= 0) & (d["op"] < 9)).all()
    assert ((d["level"] >= 0.1) & (d["level"] < SEV)).all()
    b = timg.draw_batch(0, [3, 7], 6, 9, SEV)
    for k in d:
        assert torch.equal(b[k][1], d[k])


def test_chains_dispatch_per_slot_and_op(monkeypatch):
    """One call of an op per (slot, op) that some chain takes, whatever the
    number of images."""
    calls = []

    def counting(name):
        real = taug.OPS[name]
        return lambda img, *a: calls.append(img.shape[0]) or real(img, *a)

    monkeypatch.setattr(taug, "OPS", {n: counting(n) for n in taug.OPS})
    aug = ("rotate", "posterize")
    d = timg.draw_view_params(0, 1, 201, n_aug_ops=2)
    imgs = torch.rand(200 * 3, 3, 16, 16)
    taug.apply_chains(imgs, d["depth"].flatten(), d["op"].flatten(0, 1),
                      d["level"].flatten(0, 1), d["sign"].flatten(0, 1), aug)
    assert len(calls) == 6    # 3 slots x 2 ops
    assert sum(calls) == int(d["depth"].sum())


@pytest.mark.parametrize("mode", ["tpt", "cocoop"])
def test_fused_prompt_steps_with_augmix_match_jax(mode):
    """`--aug_list` on the TPT (`--lora_encoder prompt`) and CoCoOp renders:
    one fused step each from uint8 canvases, against the JAX package's
    `make_fused_tpt_fn` / `make_fused_cocoop_fn`, every view and AugMix
    draw replayed from `sample_key`. f32 at the `test-tiny` size; 5e-4, the
    bound of the prompt-tuning and CoCoOp steps (tests/test_torch_text.py,
    tests/test_torch_cocoop.py)."""
    classes = ["goldfish", "tree_frog", "box turtle", "hen"]
    aug, n_views = ("rotate", "color", "equalize", "posterize"), 8
    kw = dict(arch="test-tiny", resolution=64, batch_size=n_views,
              compute_dtype="float32", param_dtype="float32", seed=5,
              tta_steps=1, selection_p=0.4, aug_ops=aug, aug_severity=SEV,
              **({"lora_encoder": "prompt"} if mode == "tpt"
                 else {"cocoop": True}))
    jcfg, cfg = JTTLConfig(**kw), TTLConfig(**kw)
    params = jax.tree.map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    embed = jnp.asarray(params["text"]["token_embed"])
    if mode == "tpt":
        jstate = jprompts.init_prompt_learner(embed, classes)
        tstate = prompt_learner_from_numpy(jstate, "cpu")
        jfused = jttl.make_fused_tpt_fn(J_TINY, jcfg)
        tfused = tttl.make_fused_tpt_fn(TEST_TINY, cfg)
    else:
        # a live meta-net, as in tests/test_torch_cocoop.py
        jstate = jco.init_cocoop(embed, classes, J_TINY.vision.proj_dim,
                                 jax.random.PRNGKey(3), "a_photo_of_a")
        jstate = dataclasses.replace(
            jstate, meta_b1=jnp.full_like(jstate.meta_b1, 0.5))
        tstate = cocoop_state_from_numpy(jstate, "cpu")
        jfused = jttl.make_fused_cocoop_fn(J_TINY, jcfg)
        tfused = tttl.make_fused_cocoop_fn(TEST_TINY, cfg)
    sizes = [(80, 80), (50, 72)]
    rng = np.random.default_rng(4)
    canv = np.zeros((len(sizes), 80, 80, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hs = np.array([h for h, _ in sizes], np.int32)
    ws = np.array([w for _, w in sizes], np.int32)
    idxs = np.array([11, 4], np.int32)
    keys = [jttl.sample_key(cfg.seed, int(i)) for i in idxs]
    draws = stack_draws([{**jax_draws(k, n_views),
                          **jax_aug_draws(k, n_views, aug)} for k in keys])
    with jfa.force_mode("bshd"):
        want = jax.tree.map(np.asarray, jfused(
            params, jstate, jnp.asarray(canv), jnp.asarray(hs),
            jnp.asarray(ws), jnp.asarray(idxs)))
    with tfa.force_mode("bshd"):
        got = tfused(params_from_numpy(params, "cpu"), tstate,
                     torch.from_numpy(canv), torch.from_numpy(hs),
                     torch.from_numpy(ws), draws)
    if mode == "tpt":
        (got, ctx), (want, jctx) = got, want
        np.testing.assert_allclose(ctx.numpy(), jctx, rtol=5e-4, atol=5e-4)
    names = ("logits", "losses") + (("adapted_logits",) if mode == "cocoop"
                                    else ("zero_shot_logits",))
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
    # AugMix reached the step: without it the losses differ
    plain = dataclasses.replace(cfg, aug_ops=())
    make = (tttl.make_fused_tpt_fn if mode == "tpt"
            else tttl.make_fused_cocoop_fn)
    with tfa.force_mode("bshd"):
        res = make(TEST_TINY, plain)(params_from_numpy(params, "cpu"),
                                     tstate, torch.from_numpy(canv),
                                     torch.from_numpy(hs),
                                     torch.from_numpy(ws), draws)
    res = res[0] if mode == "tpt" else res
    assert np.abs(res.losses.numpy() - want.losses).max() > 1e-4
