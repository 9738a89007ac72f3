"""PLPD (`--filter_plpd 1`) in the port against `ttl_tpu`.

The JAX step draws its counterfactual's permutations inside from the
per-step keys; the port takes them from the host. `jax_plpd_perms` replays
JAX's own permutations from the same keys (`jax.random.split(key, steps)`
of each sample's key, then a key per view for aug_type patch), so both
sides shuffle alike; nothing is redrawn.

Tolerances: the pixel shuffle and the occlusion are exact up to the f32
mean; the patch shuffle's two bilinear resizes are held against a float64
evaluation of the same weights within 2e-6, and against JAX within 5e-4:
JAX's einsum contracts the image with the outer product of its two weight
matrices, whose sum over a whole 224 x 224 window leaves it 1.2e-4 off the
float64 result at unit-normal inputs. Whole steps, the JAX side on its
einsum attention (f32 scores, as the port's default route): 5e-4, the bound
of tests/test_torch_adapt.py; image-LoRA in each aug_type, and text-LoRA
(`--lora_encoder text`), whose filter is shown to keep some views and drop
others. The threshold of each step is set in the widest
gap of the port's PLPD values near their median, far from every view's
value, so that the filter keeps some views and drops others on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttl_tpu.adapt import ttl as jttl
from ttl_tpu.config import TTLConfig
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.prompts import prompt_tokens
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops import quant as jq
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.adapt import ttl as tttl
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops import image as timg

S, V, N_CLS, RANK, RES = 2, 8, 5, 4, 64
WINDOW = (2, 3)
KEY = 9
# the classes of the text-LoRA case, whose class features come from the text
# tower and these prompts
CLASSES = ["goldfish", "tree_frog", "box turtle", "hen", "tench"]


def jax_plpd_perms(key, cfg) -> np.ndarray:
    """The permutations JAX's step consumes for one sample's `key`:
    [steps, V, patch_len**2] (patch) or [steps, H*W] (pixel)."""
    steps = jax.random.split(key, cfg.tta_steps ** 2)
    if cfg.aug_type == "patch":
        return np.stack([np.stack([
            np.asarray(jax.random.permutation(k, cfg.patch_len ** 2))
            for k in jax.random.split(sk, cfg.batch_size)]) for sk in steps])
    return np.stack([np.asarray(jax.random.permutation(sk, RES * RES))
                     for sk in steps])


def _cfg(**kw):
    return TTLConfig(arch="test-tiny", resolution=RES, batch_size=V,
                     layer_range=WINDOW, rank=RANK, compute_dtype="float32",
                     param_dtype="float32", **kw)


# ----------------------------------------------------------- counterfactuals

def _resize64(x: np.ndarray, size: int) -> np.ndarray:
    """Float64 evaluation of `resize_bilinear` with its own weights."""
    n = x.shape[-1]
    zero = torch.zeros(())
    w = timg.weight_mat(zero, zero + n, n, size, timg._triangle).double()
    w = w.numpy()
    return np.swapaxes(np.swapaxes(x.astype(np.float64), -1, -2) @ w,
                       -1, -2) @ w


@pytest.mark.parametrize("size,patch_len", [(224, 6), (64, 6), (64, 8)])
def test_patch_shuffle_matches_jax(size, patch_len):
    rng = np.random.default_rng(0)
    views = rng.standard_normal((3, 3, size, size)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda v, k: jttl._patch_shuffle(
        v, k, patch_len))(jnp.asarray(views), key))
    perm = np.stack([np.asarray(jax.random.permutation(k, patch_len ** 2))
                     for k in jax.random.split(key, 3)])
    got = tttl.patch_shuffle(torch.from_numpy(views), torch.from_numpy(perm),
                             patch_len).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    hp = size // patch_len * patch_len
    p = hp // patch_len
    x = _resize64(views, hp).reshape(3, 3, patch_len, p, patch_len, p)
    x = x.transpose(0, 2, 4, 1, 3, 5).reshape(3, patch_len ** 2, 3, p, p)
    x = x[np.arange(3)[:, None], perm].reshape(3, patch_len, patch_len, 3,
                                               p, p)
    ref = _resize64(x.transpose(0, 3, 1, 4, 2, 5).reshape(3, 3, hp, hp),
                    size)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_pixel_shuffle_matches_jax():
    rng = np.random.default_rng(1)
    views = rng.standard_normal((2, 3, 3, 32, 32)).astype(np.float32)
    keys = [jax.random.PRNGKey(i) for i in range(2)]
    want = np.stack([np.asarray(jttl._pixel_shuffle(jnp.asarray(views[i]),
                                                    keys[i]))
                     for i in range(2)])
    perm = np.stack([np.asarray(jax.random.permutation(k, 32 * 32))
                     for k in keys])
    got = tttl.pixel_shuffle(torch.from_numpy(views), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_occlude_matches_jax():
    views = np.random.default_rng(2).standard_normal((3, 3, 64, 64)).astype(
        np.float32)
    cfg = _cfg(occlusion_size=20, row_start=10, column_start=30)
    want = np.asarray(jttl._occlude(jnp.asarray(views), cfg))
    got = tttl.occlude(torch.from_numpy(views), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - views).max() > 0.1


# --------------------------------------------------------------- whole steps

@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    adapters0 = jax.tree.map(np.array, j_init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.vision.hidden, RANK, "xavier"))
    rng = np.random.default_rng(2)
    text_cls = rng.standard_normal((N_CLS, J_TINY.vision.proj_dim))
    text_cls = (text_cls / np.linalg.norm(text_cls, axis=-1,
                                          keepdims=True)).astype(np.float32)
    views = (rng.standard_normal((S, V, 3, RES, RES)) * 0.6).astype(
        np.float32)
    return params, adapters0, text_cls, views


def _keys():
    return jax.random.split(jax.random.PRNGKey(KEY), S)


def _perms(cfg):
    if cfg.aug_type not in ("patch", "pixel"):
        return None
    return torch.from_numpy(np.stack([jax_plpd_perms(k, cfg)
                                      for k in _keys()]))


def _tokens(cfg):
    """The class-prompt table of text-LoRA, else None."""
    if cfg.lora_encoder != "text":
        return None
    return np.asarray(prompt_tokens(CLASSES))


def _threshold(cfg, params, text_cls, views, perms) -> float:
    """The middle of the widest gap between the port's first-step PLPD
    values (sorted) in their middle half. In text mode the classifier is
    the text tower's over the class prompts: at the first step the adapters'
    B is zero, so they add nothing."""
    tp = params_from_numpy(params, "cpu")
    if cfg.lora_encoder == "text":
        with torch.no_grad():
            text_cls = tclip.l2_normalize(tclip.text_features(
                tp["text"], torch.from_numpy(_tokens(cfg)), TEST_TINY.text,
                compute_dtype=torch.float32)).numpy()
    flat = torch.from_numpy(views)
    x_prime = (tttl.patch_shuffle(flat.flatten(0, 1),
                                  perms[:, 0].flatten(0, 1), cfg.patch_len)
               if cfg.aug_type == "patch" else
               tttl.pixel_shuffle(flat, perms[:, 0]).flatten(0, 1)
               if cfg.aug_type == "pixel" else
               tttl.occlude(flat.flatten(0, 1), cfg))

    def logits(x):
        f = tclip.l2_normalize(tclip.encode_image(
            tp["vision"], x, TEST_TINY.vision, compute_dtype=torch.float32))
        return torch.exp(tp["logit_scale"]) * f @ torch.from_numpy(
            text_cls).T

    with torch.no_grad():
        plpd = np.sort(tttl._plpd(logits(flat.flatten(0, 1)),
                                  logits(x_prime)).numpy())
    mid = plpd[len(plpd) // 4: 3 * len(plpd) // 4 + 1]
    i = int(np.argmax(np.diff(mid)))
    return float((mid[i] + mid[i + 1]) / 2)


def _jax_step(cfg, params, adapters0, text_cls, views):
    tokens = _tokens(cfg)
    with jfa.force_mode(""):
        res = jttl.make_batched_ttl_fn(
            J_TINY, cfg, tokens=None if tokens is None else jnp.asarray(
                tokens))(
            params, jnp.asarray(text_cls), adapters0, jnp.asarray(views),
            _keys())
        return np.asarray(res.logits)


def _torch_step(cfg, params, adapters0, text_cls, views):
    return tttl.make_batched_ttl_fn(TEST_TINY, cfg, tokens=_tokens(cfg))(
        params_from_numpy(params, "cpu"), torch.from_numpy(text_cls),
        adapters_from_numpy(adapters0, "cpu"), torch.from_numpy(views),
        _perms(cfg)).logits.numpy()


@pytest.mark.parametrize(
    "aug_type,tta_steps,lora_encoder",
    [("patch", 1, "image"), ("patch", 2, "image"), ("pixel", 1, "image"),
     ("occ", 1, "image"), ("patch", 1, "text")],
    ids=["patch-1", "patch-2", "pixel-1", "occ-1", "patch-1-text"])
def test_plpd_step_matches_jax(setup, monkeypatch, aug_type, tta_steps,
                               lora_encoder):
    """Image-LoRA in each aug_type, and text-LoRA (`--lora_encoder text
    --filter_plpd 1`: the counterfactual's logits take the class features
    of the step's own adapters)."""
    params, adapters0, text_cls, views = setup
    kw = dict(tta_steps=tta_steps, aug_type=aug_type, occlusion_size=24,
              row_start=16, column_start=8, lora_encoder=lora_encoder)
    probe = _cfg(filter_plpd=1, **kw)
    threshold = _threshold(probe, params, text_cls, views, _perms(probe))
    cfg = _cfg(filter_plpd=1, plpd_threshold=threshold, **kw)
    want = _jax_step(cfg, params, adapters0, text_cls, views)
    got = _torch_step(cfg, params, adapters0, text_cls, views)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    # the filter changed the step, so the comparison is not vacuous
    if lora_encoder == "image":
        unfiltered = _torch_step(_cfg(**kw), params, adapters0, text_cls,
                                 views)
        assert np.abs(got - unfiltered).max() > 1e-3
    else:
        # AdamW's first update is lr * sign(g), and the text adapters'
        # gradient keeps its signs over the views the filter drops, so the
        # logits barely move: the filter shows in the views it keeps
        kept, deyo = [], tttl.deyo_loss

        def recording(*args, **kwargs):
            loss, aux = deyo(*args, **kwargs)
            kept.append(aux["keep"].sum(-1))
            return loss, aux

        monkeypatch.setattr(tttl, "deyo_loss", recording)
        _torch_step(cfg, params, adapters0, text_cls, views)
        assert ((kept[0] > 0) & (kept[0] < V)).all(), kept


def test_plpd_step_with_int8_prefix_matches_jax(setup):
    """`--prefix_quant int8 --filter_plpd 1`: the counterfactual's prefix
    runs int8 too (JAX's vision_prefix picks `prefix_q` from the params).
    Bound as tests/test_torch_adapt.py's int8 step: 5e-4 plus a quarter of
    the whole int8 effect."""
    params, adapters0, text_cls, views = setup
    probe = _cfg(tta_steps=1, filter_plpd=1, prefix_quant="int8")
    qparams = jax.tree.map(np.asarray, jq.attach_prefix_quant(
        params, jq.quant_prefix_len(probe, J_TINY), drop_fp=True))
    threshold = _threshold(probe, qparams, text_cls, views, _perms(probe))
    cfg = _cfg(tta_steps=1, filter_plpd=1, prefix_quant="int8",
               plpd_threshold=threshold)
    want = _jax_step(cfg, qparams, adapters0, text_cls, views)
    fp = _jax_step(cfg, params, adapters0, text_cls, views)
    got = _torch_step(cfg, qparams, adapters0, text_cls, views)
    effect = np.abs(want - fp).max()
    bound = 5e-4 + 0.25 * effect
    assert effect > bound
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= bound


# -------------------------------------------------------------------- draws

def test_plpd_draws_per_seed_index_and_step():
    cfg = _cfg(tta_steps=2, filter_plpd=1)
    a = tttl.draw_plpd_perms(cfg, 7)
    assert a.shape == (4, V, 36)
    assert torch.equal(a.sort(dim=-1).values,
                       torch.arange(36).expand(4, V, 36))
    assert torch.equal(a, tttl.draw_plpd_perms(cfg, 7))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, tttl.draw_plpd_perms(cfg, 8))
    pixel = tttl.draw_plpd_perms(_cfg(filter_plpd=1, aug_type="pixel"), 7)
    assert pixel.shape == (1, RES * RES)
    assert tttl.draw_plpd_perms(_cfg(filter_plpd=1, aug_type="occ"),
                                7) is None


def test_sample_draws_carry_plpd_perms_only_where_the_step_reads_them():
    on = trunner.sample_draws(_cfg(filter_plpd=1), [3, 5])
    assert on["plpd_perm"].shape == (2, 1, V, 36)
    assert torch.equal(on["plpd_perm"][1], tttl.draw_plpd_perms(
        _cfg(filter_plpd=1), 5))
    for cfg in (_cfg(), _cfg(filter_plpd=1, deyo_selection=False),
                _cfg(filter_plpd=1, aug_type="occ"),
                _cfg(filter_plpd=1, cocoop=True)):
        assert "plpd_perm" not in trunner.sample_draws(cfg, [3])
    assert trunner.sample_draws(_cfg(filter_plpd=1, tta_steps=0), [3]) == {}


def test_check_supported_takes_plpd_and_augmix():
    tttl.check_supported(_cfg(filter_plpd=1, aug_ops=("rotate", "color")))
    with pytest.raises(ValueError, match="unknown AugMix ops"):
        tttl.check_supported(_cfg(aug_ops=("rotate", "blur")))


def test_fused_step_with_plpd_and_augmix_matches_jax(setup):
    """The slice as a whole: canvases to adapted logits with AugMix views
    (a geometric, a pointwise and two threshold ops; all 13 ops are held
    against JAX in tests/test_torch_augmix.py) and PLPD's patch filter,
    against the JAX package's `make_fused_ttl_fn`, every draw (views,
    AugMix, permutations) replayed from `sample_key`. Bound 5e-4, as the
    steps."""
    from test_torch_augmix import jax_aug_draws
    from test_torch_image import jax_draws, stack_draws

    from ttl_tpu.adapt.ttl import sample_key

    params, adapters0, text_cls, _ = setup
    sizes = [(80, 80), (50, 72)]
    rng = np.random.default_rng(4)
    canv = np.zeros((len(sizes), 80, 80, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hs = np.array([h for h, _ in sizes], np.int32)
    ws = np.array([w for _, w in sizes], np.int32)
    idxs = np.array([11, 4], np.int32)
    aug = ("rotate", "color", "equalize", "posterize")
    kw = dict(seed=5, tta_steps=1, filter_plpd=1, aug_ops=aug, aug_severity=3)
    probe = _cfg(**kw)
    keys = [sample_key(probe.seed, int(i)) for i in idxs]
    draws = stack_draws([{**jax_draws(k, V), **jax_aug_draws(k, V, aug, 3)}
                         for k in keys])
    draws["plpd_perm"] = torch.from_numpy(np.stack(
        [jax_plpd_perms(k, probe) for k in keys]))
    args = (torch.from_numpy(canv), torch.from_numpy(hs),
            torch.from_numpy(ws))
    views = timg.render_views(*args, draws, out_size=RES,
                              out_dtype=torch.float32, aug_ops=aug).numpy()
    cfg = _cfg(plpd_threshold=_threshold(probe, params, text_cls, views,
                                         draws["plpd_perm"]), **kw)
    with jfa.force_mode(""):
        want = np.asarray(jttl.make_fused_ttl_fn(J_TINY, cfg)(
            params, jnp.asarray(text_cls), adapters0, jnp.asarray(canv),
            jnp.asarray(hs), jnp.asarray(ws), jnp.asarray(idxs)).logits)
    got = tttl.make_fused_ttl_fn(TEST_TINY, cfg)(
        params_from_numpy(params, "cpu"), torch.from_numpy(text_cls),
        adapters_from_numpy(adapters0, "cpu"), *args, draws).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_runner_runs_plpd_and_augmix_end_to_end():
    """`runner.run` on the CPU with both options (the other aug_types run
    in the step tests above)."""
    from ttl_tpu_torch.data.views import ArrayDataset

    ds = ArrayDataset(np.random.default_rng(5).integers(
        0, 256, (3, 40, 56, 3), dtype=np.uint8), np.array([3, 1, 0]))
    cfg = _cfg(tta_steps=1, sample_batch=2, workers=1, filter_plpd=1,
               aug_ops=("rotate", "equalize", "color"))
    top1, top5 = trunner.run(cfg, device="cpu", datasets={"A": ds})["A"]
    assert 0.0 <= top1 <= top5 <= 100.0
