"""K6, layernorm folded into the linear behind it, and the `fused_ln` route
of the vision tower, against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both sides.

- `ln_matmul_plain` against the JAX `ln_matmul` (its Pallas kernel in
  interpret mode, as it runs off the TPU by itself) and against
  `reference_ln_matmul`. f32: rtol/atol 1e-5, the bound of the JAX package's
  own test of the kernel (sums in another order). bf16: one bf16 step of the
  output's scale. Both sides round the normalised row and the output once,
  but XLA on the CPU may keep the row in f32 where the source says bf16, and
  the f32 statistics differ in the last place, so a normalised value may
  round the other way: each such flip moves an output by 2^-8 * |w| (about
  2e-4 here), far below one output step (2^-8 * max |out|), which is what a
  flip of the output's own rounding costs.
- `encoder_layer(fused_ln=True)` and `encode_image(fused_ln=True)` against
  the JAX `encoder_layer` / `encode_image` (layer_norm then linear) at the
  test-tiny size: f32 within 1e-4, the towers' bound in
  tests/test_torch_clip.py; bf16 within a stated number of bf16 steps.
- `fused_ln=True` with adapters or where a gradient would flow raises;
  with the whole tower int8 the fused call is reached 0 times.
- `cuda`-marked cases hold the kernel against its plain version on the card
  (they skip where there is none).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttl_tpu.models import clip as jclip
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops.ln_matmul import ln_matmul as j_ln_matmul
from ttl_tpu.ops.ln_matmul import reference_ln_matmul as j_reference
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops import ln_matmul as tlm
from ttl_tpu_torch.ops import quant as tq

BF16_STEP = 2.0 ** -8   # relative spacing of bf16 values


def _inputs(m, k, n, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2.0 + 0.5).astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    scale = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, scale, bias, w, b


def _port(arrays, dtype):
    x, scale, bias, w, b = (torch.from_numpy(a) for a in arrays)
    return tlm.ln_matmul_plain(x.to(dtype), scale, bias, w.to(dtype), b)


@pytest.mark.parametrize("m", [300, 1, 255, 257])
def test_plain_matches_jax_f32(m):
    """[300, 256] x [256, 384] as the JAX package's own test of the kernel,
    and ragged M around the Pallas row tile of 256."""
    arrays = _inputs(m, 256, 384, seed=m)
    got = _port(arrays, torch.float32).numpy()
    jarrays = [jnp.asarray(a) for a in arrays]
    assert got.shape == (m, 384)
    np.testing.assert_allclose(got, np.asarray(j_ln_matmul(*jarrays)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_reference(*jarrays)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [255, 257, 1])
def test_plain_matches_jax_bf16_within_one_output_step(m):
    arrays = _inputs(m, 256, 384, seed=10 + m)
    got = _port(arrays, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    x, scale, bias, w, b = arrays
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
             jnp.asarray(bias), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b))
    for want in (j_ln_matmul(*jargs), j_reference(*jargs)):
        want = np.asarray(want.astype(jnp.float32))
        bound = BF16_STEP * max(1.0, np.abs(want).max())
        assert np.abs(got.float().numpy() - want).max() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_of_zeros_stay_finite(dtype):
    """A row of zeros has var = 0: rsqrt(eps) * 0 = 0, so the row comes out
    as ln_bias @ w + b. The tower's pad rows are such rows."""
    arrays = _inputs(9, 64, 48, seed=3, zero_rows=(0, 4, 8))
    got = _port(arrays, dtype).float()
    assert torch.isfinite(got).all()
    _, _, bias, w, b = (torch.from_numpy(a) for a in arrays)
    want = (bias.to(dtype).float() @ w.to(dtype).float() + b)
    for r in (0, 4, 8):
        torch.testing.assert_close(got[r], want.to(dtype).float(),
                                   rtol=2 * BF16_STEP, atol=1e-5)
    jwant = np.asarray(j_ln_matmul(*[jnp.asarray(a) for a in arrays]))
    assert np.isfinite(jwant).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-5, atol=1e-5)


def test_ln_matmul_takes_plain_on_cpu_and_keeps_leading_axes():
    arrays = _inputs(24, 32, 48, seed=4)
    x, scale, bias, w, b = (torch.from_numpy(a) for a in arrays)
    before = tlm.ln_matmul.launches
    got = tlm.ln_matmul(x.reshape(2, 3, 4, 32), scale, bias, w, b)
    assert got.shape == (2, 3, 4, 48)
    assert torch.equal(got.reshape(24, 48),
                       tlm.ln_matmul_plain(x, scale, bias, w, b))
    assert tlm.ln_matmul.launches == before   # no kernel on a CPU tensor


def test_ln_matmul_cuda_refuses_cpu_tensors():
    x, scale, bias, w, b = (torch.from_numpy(a)
                            for a in _inputs(4, 32, 48, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        tlm.ln_matmul_cuda(x, scale, bias, w, b)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tlm.ln_matmul_cuda(x[0], scale, bias, w, b)
    with pytest.raises(ValueError, match="must be one of"):
        tlm.ln_matmul_cuda(x.half(), scale, bias, w.half(), b)


# ------------------------------------------------- the towers' fused_ln route

@pytest.fixture(scope="module")
def tiny():
    params = jax.tree.map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    rng = np.random.default_rng(1)
    # layernorm affines and biases away from (1, 0): every term of K6 counts
    for ln in ("ln1", "ln2"):
        shape = params["vision"]["layers"][ln]["scale"].shape
        params["vision"]["layers"][ln] = {
            "scale": (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32),
            "bias": (0.2 * rng.standard_normal(shape)).astype(np.float32)}
    for group, names in (("attn", "qkvo"), ("mlp", ("fc1", "fc2"))):
        for name in names:
            lin = params["vision"]["layers"][group][name]
            lin["b"] = (0.1 * rng.standard_normal(lin["b"].shape)
                        ).astype(np.float32)
    images = rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    return params, images


def _jax_layer(layer, x, dtype):
    cast = jax.tree.map(lambda a: jnp.asarray(a), layer)
    with jfa.force_mode("bshd"):
        out = jclip.encoder_layer(cast, jnp.asarray(x, dtype), heads=2,
                                  eps=1e-5, causal=False, seq_len=17)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype,steps", [("float32", 0), ("bfloat16", 4)])
def test_encoder_layer_fused_ln_matches_jax(tiny, dtype, steps):
    """One layer on [3, 32, 32] tokens (17 true, 15 zero pad rows). f32:
    1e-4. bf16: q, k, v and fc1 differ from `linear` by one rounding each
    and the residual stream rounds after every add, so the bound is `steps`
    bf16 steps of the output's scale (4: two roundings a branch, two
    branches)."""
    params, _ = tiny
    layer = jax.tree.map(lambda a: a[1], params["vision"]["layers"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 32, 32)).astype(np.float32)
    x[:, 17:] = 0.0
    want = _jax_layer(layer, x, jnp.dtype(dtype))
    tdtype = getattr(torch, dtype)
    tlayer = params_from_numpy(layer, "cpu")
    kw = dict(heads=2, eps=1e-5, causal=False, seq_len=17)
    with torch.no_grad():
        got = tclip.encoder_layer(tlayer, torch.from_numpy(x).to(tdtype),
                                  fused_ln=True, **kw)
        unfused = tclip.encoder_layer(tlayer, torch.from_numpy(x).to(tdtype),
                                      **kw)
    assert got.dtype == tdtype and torch.isfinite(got).all()
    got, unfused = got.float().numpy()[:, :17], unfused.float().numpy()[:, :17]
    want = want[:, :17]
    if steps == 0:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, unfused, rtol=1e-5, atol=1e-5)
    else:
        bound = steps * BF16_STEP * np.abs(want).max()
        assert np.abs(got - want).max() <= bound
        assert np.abs(got - unfused).max() <= bound


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_encode_image_fused_ln_matches_jax(tiny, dtype, tol):
    """The whole frozen tower, 4 layers. f32: 1e-4. bf16: features of size
    about 0.3 after four layers of bf16 residuals; 0.05 absolute, the bound
    the card-against-CPU runs of the bf16 paths use for their logits."""
    params, images = tiny
    with jfa.force_mode("bshd"):
        want = np.asarray(jclip.encode_image(
            params["vision"], jnp.asarray(images), J_TINY.vision,
            compute_dtype=jnp.dtype(dtype)))
    tparams = params_from_numpy(params["vision"], "cpu")
    with torch.no_grad():
        got = tclip.encode_image(tparams, torch.from_numpy(images),
                                 TEST_TINY.vision,
                                 compute_dtype=getattr(torch, dtype),
                                 fused_ln=True).numpy()
    assert got.shape == want.shape == (3, TEST_TINY.vision.proj_dim)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_fused_ln_refuses_adapters_and_gradients(tiny):
    params, images = tiny
    tparams = params_from_numpy(params["vision"], "cpu")
    layer = tclip.layer_at(tparams["layers"], 0)
    x = torch.zeros(1, 32, 32)
    lora = {m: {"A": torch.zeros(32, 4), "B": torch.zeros(4, 32)}
            for m in "qv"}
    kw = dict(heads=2, eps=1e-5, causal=False, seq_len=17, fused_ln=True)
    with pytest.raises(ValueError, match="LoRA"):
        tclip.encoder_layer(layer, x, lora=lora, **kw)
    with pytest.raises(ValueError, match="forward only"):
        tclip.encoder_layer(layer, x.clone().requires_grad_(True), **kw)
    with torch.no_grad():   # the same input is fine where no gradient flows
        tclip.encoder_layer(layer, x.clone().requires_grad_(True), **kw)
    adapters = {m: {"A": torch.zeros(2, 32, 4), "B": torch.zeros(2, 4, 32)}
                for m in "qv"}
    with pytest.raises(ValueError, match="LoRA"):
        tclip.vision_features(tparams, torch.from_numpy(images),
                              TEST_TINY.vision, adapters=adapters,
                              adapter_window=(2, 3), fused_ln=True)


def test_fused_ln_calls_per_layer_and_none_under_a_whole_int8_tower(
        tiny, monkeypatch):
    """Four fused calls a layer (q, k, v, fc1); with the whole tower int8
    (`--cocoop --prefix_quant int8`) its layers stay on the int8 linears and
    the fused call is reached 0 times."""
    params, images = tiny
    calls = []
    real = tclip.ln_matmul

    def counting(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(tclip, "ln_matmul", counting)
    tparams = params_from_numpy(params, "cpu")
    with torch.no_grad():
        fp = tclip.encode_image(tparams["vision"], torch.from_numpy(images),
                                TEST_TINY.vision,
                                compute_dtype=torch.float32, fused_ln=True)
    assert len(calls) == 4 * TEST_TINY.vision.layers
    assert set(calls) == {(3, 32, 32)}
    calls.clear()
    qparams = tq.attach_prefix_quant(tparams, TEST_TINY.vision.layers,
                                     drop_fp=True)
    with torch.no_grad():
        q = tclip.encode_image(qparams["vision"], torch.from_numpy(images),
                               TEST_TINY.vision, compute_dtype=torch.float32,
                               fused_ln=True)
    assert calls == []
    assert q.shape == fp.shape and torch.isfinite(q).all()


# ------------------------------------------------- K6 (needs the card)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [
    (1000, 768, 768, torch.bfloat16),    # M not a multiple of any row tile
    (40000, 768, 3072, torch.bfloat16),  # the 128-row tile
    (257, 512, 2048, torch.bfloat16),
    (130, 1024, 4096, torch.bfloat16),
    (1, 640, 640, torch.bfloat16),
    (77, 48, 80, torch.bfloat16),        # K, N not multiples of the tiles
    (300, 256, 384, torch.float32),
    (33, 768, 768, torch.float32),
    (5, 48, 80, torch.float32),
])
def test_k6_matches_plain_on_card(cuda_device, m, k, n, dtype):
    """bf16: the normalised row and the output each round once and the sums
    run in another order, so an output may round the other way: two bf16
    steps of the output's scale. f32: order only, 1e-5 of the scale."""
    arrays = _inputs(m, k, n, seed=m, zero_rows=(0, m // 2))
    x, scale, bias, w, b = (tensor_from_numpy(a, cuda_device) for a in arrays)
    x, w = x.to(dtype), w.to(dtype)
    tlm.ln_matmul.launches = 0
    got = tlm.ln_matmul(x, scale, bias, w, b)
    want = tlm.ln_matmul_plain(x, scale, bias, w, b)
    torch.cuda.synchronize()
    assert tlm.ln_matmul.launches == 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    rel = 2 * BF16_STEP if dtype == torch.bfloat16 else 1e-5
    bound = rel * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_k6_refuses_what_it_does_not_take(cuda_device):
    arrays = _inputs(8, 64, 48, seed=6)
    x, scale, bias, w, b = (tensor_from_numpy(a, cuda_device) for a in arrays)
    with pytest.raises(ValueError, match="multiples of 16"):
        tlm.ln_matmul_cuda(x[:, :40].contiguous(), scale[:40], bias[:40],
                           w[:40].contiguous(), b)
    with pytest.raises(ValueError, match="contiguous"):
        tlm.ln_matmul_cuda(x.t().contiguous().t(), scale, bias, w, b)
    with pytest.raises(ValueError, match="must be"):
        tlm.ln_matmul_cuda(x.bfloat16(), scale, bias, w, b)
    big = torch.zeros(2, 8192, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        tlm.ln_matmul_cuda(big, torch.ones(8192, device=cuda_device),
                           torch.zeros(8192, device=cuda_device),
                           torch.zeros(8192, 16, device=cuda_device),
                           torch.zeros(16, device=cuda_device))
