"""The port's DeYO loss and batched episodic step against the JAX package.

The batched step is held against `make_batched_ttl_fn` on the same bridged
weights, views and `adapters0`, with the JAX side on the bshd kernel route
(`force_mode("bshd")`, Pallas in interpret mode). Adapted logits must agree
within rtol/atol 5e-4, the bound of tests/test_composite_oracle.py: f32 sums
in another order through the window forward, backward and AdamW. With the
int8 prefix, see the bound of `test_batched_step_with_int8_prefix_matches_jax`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttl_tpu.adapt.ttl import make_batched_ttl_fn as j_make_batched
from ttl_tpu.config import TTLConfig
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops.entropy import deyo_loss as j_deyo_loss
from ttl_tpu.ops import quant as jq
from ttl_tpu.ops.lora import init_adapters as j_init_adapters
from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops.entropy import deyo_loss

S, V, N_CLS, RANK = 2, 8, 5, 4
WINDOW = (2, 3)


@pytest.mark.parametrize("filter_ent,reweight_ent,filter_plpd",
                         [(0, 1, 0), (1, 1, 0), (0, 0, 0), (0, 1, 1)])
def test_deyo_loss_and_grad_match_jax(filter_ent, reweight_ent, filter_plpd):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((16, 7)) * 3).astype(np.float32)
    plpd = rng.uniform(0, 0.4, 16).astype(np.float32)
    kw = dict(filter_ent=bool(filter_ent), selection_p=0.25,
              reweight_ent=float(reweight_ent),
              filter_plpd=bool(filter_plpd))

    def jloss(x):
        return j_deyo_loss(x, plpd=jnp.asarray(plpd), **kw)[0]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got, aux = deyo_loss(x, plpd=torch.from_numpy(plpd), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)
    _, jaux = j_deyo_loss(jnp.asarray(logits), plpd=jnp.asarray(plpd), **kw)
    np.testing.assert_array_equal(aux["keep"].numpy(),
                                  np.asarray(jaux["keep"]))
    assert aux["n_backward"].item() == float(jaux["n_backward"])


def test_deyo_loss_batched_rows_are_independent():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 16, 7)).astype(
        np.float32))
    batched, aux = deyo_loss(logits, filter_ent=True, selection_p=0.25)
    assert batched.shape == aux["n_backward"].shape == (3,)
    for i in range(3):
        one, _ = deyo_loss(logits[i], filter_ent=True, selection_p=0.25)
        torch.testing.assert_close(batched[i], one)


@pytest.fixture(scope="module")
def setup():
    params = init_clip_params(jax.random.PRNGKey(0), J_TINY,
                              param_dtype=jnp.float32)
    adapters0 = j_init_adapters(jax.random.PRNGKey(1), 2,
                                J_TINY.vision.hidden, RANK, "xavier")
    rng = np.random.default_rng(2)
    text_cls = rng.standard_normal((N_CLS, J_TINY.vision.proj_dim))
    text_cls = (text_cls / np.linalg.norm(text_cls, axis=-1,
                                          keepdims=True)).astype(np.float32)
    views = (rng.standard_normal((S, V, 3, 64, 64)) * 0.6).astype(np.float32)
    params = jax.tree.map(np.array, params)
    adapters0 = jax.tree.map(np.array, adapters0)
    return params, adapters0, text_cls, views


def _cfg(**kw):
    return TTLConfig(arch="test-tiny", resolution=64, batch_size=V,
                     layer_range=WINDOW, rank=RANK, compute_dtype="float32",
                     param_dtype="float32", **kw)


def _jax_step(cfg, params, adapters0, text_cls, views):
    with jfa.force_mode("bshd"):
        fn = j_make_batched(J_TINY, cfg, zero_shot_aux=True)
        res = fn(params, jnp.asarray(text_cls), adapters0, jnp.asarray(views),
                 jax.random.split(jax.random.PRNGKey(9), views.shape[0]))
        return np.asarray(res.logits), np.asarray(res.zero_shot_logits)


def _torch_step(cfg, params, adapters0, text_cls, views):
    fn = make_batched_ttl_fn(TEST_TINY, cfg)
    return fn(params_from_numpy(params, "cpu"), torch.from_numpy(text_cls),
              adapters_from_numpy(adapters0, "cpu"), torch.from_numpy(views))


@pytest.mark.parametrize("tta_steps", [1, 2])
def test_batched_step_matches_jax(setup, tta_steps):
    params, adapters0, text_cls, views = setup
    cfg = _cfg(tta_steps=tta_steps)
    want, zero_shot = _jax_step(cfg, params, adapters0, text_cls, views)
    res = _torch_step(cfg, params, adapters0, text_cls, views)
    assert res.losses.shape == (S, tta_steps ** 2)
    np.testing.assert_allclose(res.logits.numpy(), want, rtol=5e-4,
                               atol=5e-4)
    # the adaptation moved the logits, so the comparison is not vacuous
    assert np.abs(want - zero_shot).max() > 1e-3


def test_no_kept_view_skips_the_update(setup):
    """filter_ent with int(V * selection_p) == 0 keeps no view: the sample's
    adapters and logits stay at the episodic start, weight decay included."""
    params, adapters0, text_cls, views = setup
    cfg = _cfg(tta_steps=1, filter_ent=1, selection_p=0.01)
    want, zero_shot = _jax_step(cfg, params, adapters0, text_cls, views)
    res = _torch_step(cfg, params, adapters0, text_cls, views)
    for m in "qv":
        for ab in "AB":
            start = torch.from_numpy(adapters0[m][ab]).expand(S, -1, -1, -1)
            assert torch.equal(res.adapters[m][ab], start)
    np.testing.assert_allclose(want, zero_shot, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.logits.numpy(), want, rtol=5e-4,
                               atol=5e-4)


def test_batched_step_with_int8_prefix_matches_jax(setup):
    """The step with the 2-layer prefix int8 (`--prefix_quant int8`), on
    the bridged JAX int8 copy. The int8 codes depend on f32 sums taken in
    another order, so a code can flip (tests/test_torch_quant.py). A flip
    is one rounding gone the other way among the thousands whose sum is the
    whole int8 effect (JAX int8 against JAX fp), so the bound is the f32
    step's 5e-4 plus a quarter of that effect; the effect itself must exceed
    the bound, so a step that ignored the int8 copy would fail."""
    params, adapters0, text_cls, views = setup
    cfg = _cfg(tta_steps=1, prefix_quant="int8")
    qparams = jax.tree.map(np.asarray, jq.attach_prefix_quant(
        params, jq.quant_prefix_len(cfg, J_TINY), drop_fp=True))
    assert qparams["vision"]["prefix_q"]["ln1"]["scale"].shape[0] == 2
    want, _ = _jax_step(cfg, qparams, adapters0, text_cls, views)
    fp, _ = _jax_step(cfg, params, adapters0, text_cls, views)
    got = _torch_step(cfg, qparams, adapters0, text_cls, views).logits.numpy()
    effect = np.abs(want - fp).max()
    bound = 5e-4 + 0.25 * effect
    assert effect > bound
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= bound
