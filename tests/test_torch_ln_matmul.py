"""K6, layernorm folded into the linear behind it, and the towers' `fold`
route (`fold="f32"`, CoCoOp's request), against the JAX package on the CPU.

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
- `encoder_layer(fold="f32")` and `encode_image(fold="f32")` against
  the JAX `encoder_layer` / `encode_image` (layer_norm then linear) at the
  test-tiny size: f32 within 1e-4, the towers' bound in
  tests/test_torch_clip.py; bf16 within a stated number of bf16 steps.
- `fold="f32"` with adapters or where a gradient would flow raises;
  with the whole tower int8 the fused call is reached 0 times.
- The "linear" epilogue of the plain version is `linear(layer_norm(x))`
  (and `quick_gelu` of it) bit for bit; `vision_prefix` folds its frozen
  layers with it wherever no gradient reaches them (four calls a layer),
  and nowhere else.
- K6's bf16 body emulated on the CPU (`emulate_k6`): its shared-memory
  layouts against what wgmma's descriptors read, and its walk over the
  tiles against `ln_matmul_plain` and JAX's reference.
- `cuda`-marked cases hold the kernel against its plain version on the card
  (they skip where there is none).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
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


# ------------------------------------------------- the "linear" epilogue

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (768, 4096),
                                 (1024, 768), (1024, 3072), (1024, 4096)])
def test_plain_linear_epilogue_is_layer_norm_then_linear(k, n, gelu, dtype):
    """The plain version with the "linear" epilogue gives the bits of the
    package's own layer_norm -> linear (-> quick_gelu), at the prefix's
    widths; the bias stored in f32, rounded to x's dtype as `linear` does."""
    arrays = _inputs(5, k, n, seed=k + n, zero_rows=(2,))
    x, scale, bias, w, b = (torch.from_numpy(a) for a in arrays)
    x, w = x.to(dtype).reshape(1, 5, k), w.to(dtype)
    got = tlm.ln_matmul_plain(x, scale, bias, w, b, 1e-5, "linear", gelu)
    want = tclip.linear(tclip.layer_norm(x, {"scale": scale, "bias": bias},
                                         1e-5), {"w": w, "b": b})
    if gelu:
        want = tclip.quick_gelu(want)
    assert got.dtype == dtype and got.shape == (1, 5, n)
    assert torch.equal(got, want)
    assert torch.equal(tlm.ln_matmul(x, scale, bias, w, b, 1e-5,
                                     epilogue="linear", quick_gelu=gelu),
                       want)


def test_epilogue_names_are_checked():
    x, scale, bias, w, b = (torch.from_numpy(a)
                            for a in _inputs(4, 32, 48, seed=7))
    with pytest.raises(ValueError, match="epilogue"):
        tlm.ln_matmul(x, scale, bias, w, b, epilogue="bf16")
    with pytest.raises(ValueError, match="quick_gelu only"):
        tlm.ln_matmul(x, scale, bias, w, b, quick_gelu=True)
    with pytest.raises(ValueError, match="epilogue"):
        tlm.ln_matmul_cuda(x, scale, bias, w, b, epilogue="bf16")


# ----------------------------------------------------- the towers' fold route

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
                                  fold="f32", **kw)
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
                                 fold="f32").numpy()
    assert got.shape == want.shape == (3, TEST_TINY.vision.proj_dim)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_fused_ln_refuses_adapters_and_gradients(tiny):
    params, images = tiny
    tparams = params_from_numpy(params["vision"], "cpu")
    layer = tclip.layer_at(tparams["layers"], 0)
    x = torch.zeros(1, 32, 32)
    lora = {m: {"A": torch.zeros(32, 4), "B": torch.zeros(4, 32)}
            for m in "qv"}
    kw = dict(heads=2, eps=1e-5, causal=False, seq_len=17, fold="f32")
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
                              adapter_window=(2, 3), fold="f32")


def test_fused_ln_calls_per_layer_and_none_under_a_whole_int8_tower(
        tiny, monkeypatch):
    """Four fused calls a layer (q, k, v, fc1); with the whole tower int8
    (`--cocoop --prefix_quant int8`) its layers stay on the int8 linears and
    the fused call is reached 0 times."""
    params, images = tiny
    calls = []
    real = tclip.ln_matmul

    def counting(x, *args, **kw):
        calls.append(tuple(x.shape))
        return real(x, *args, **kw)

    monkeypatch.setattr(tclip, "ln_matmul", counting)
    tparams = params_from_numpy(params, "cpu")
    with torch.no_grad():
        fp = tclip.encode_image(tparams["vision"], torch.from_numpy(images),
                                TEST_TINY.vision,
                                compute_dtype=torch.float32, fold="f32")
    assert len(calls) == 4 * TEST_TINY.vision.layers
    assert set(calls) == {(3, 32, 32)}
    calls.clear()
    qparams = tq.attach_prefix_quant(tparams, TEST_TINY.vision.layers,
                                     drop_fp=True)
    with torch.no_grad():
        q = tclip.encode_image(qparams["vision"], torch.from_numpy(images),
                               TEST_TINY.vision, compute_dtype=torch.float32,
                               fold="f32")
    assert calls == []
    assert q.shape == fp.shape and torch.isfinite(q).all()


def _counting(monkeypatch):
    """Record (input shape, epilogue, quick_gelu) of every fused call the
    towers make."""
    calls = []
    real = tclip.ln_matmul

    def counting(x, *args, **kw):
        calls.append((tuple(x.shape), kw.get("epilogue", "f32"),
                      kw.get("quick_gelu", False)))
        return real(x, *args, **kw)

    monkeypatch.setattr(tclip, "ln_matmul", counting)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vision_prefix_folds_four_calls_a_layer_without_gradient(
        tiny, monkeypatch, dtype):
    """Under no_grad each prefix layer makes four fused calls with the
    "linear" epilogue (q, k, v; fc1 with QuickGELU), and the hidden state
    is the unfused one's bit for bit."""
    params, images = tiny
    tparams = params_from_numpy(params["vision"], "cpu")
    cfg, upto = TEST_TINY.vision, 3
    x = torch.from_numpy(images)
    unfused = tclip.vision_prefix(tparams, x.clone().requires_grad_(True),
                                  cfg, upto=upto, compute_dtype=dtype)
    calls = _counting(monkeypatch)
    with torch.no_grad():
        got = tclip.vision_prefix(tparams, x, cfg, upto=upto,
                                  compute_dtype=dtype)
    rows = (3, 32, cfg.hidden)
    layer = [(rows, "linear", False)] * 3 + [(rows, "linear", True)]
    assert calls == layer * upto
    assert torch.equal(got, unfused.detach())


def test_vision_prefix_makes_no_fused_call_where_a_gradient_reaches(
        tiny, monkeypatch):
    """An input that needs a gradient, or layer weights that do, keep the
    prefix unfused; so does TTL_LN_STATS=ex2, whose variance K6 does not
    compute."""
    params, images = tiny
    cfg = TEST_TINY.vision
    x = torch.from_numpy(images)
    calls = _counting(monkeypatch)
    tparams = params_from_numpy(params["vision"], "cpu")
    out = tclip.vision_prefix(tparams, x.clone().requires_grad_(True), cfg,
                              upto=2, compute_dtype=torch.float32)
    assert out.requires_grad and calls == []
    trained = dict(tparams)
    trained["layers"] = tclip.tree_map(
        lambda t: t.clone().requires_grad_(True), tparams["layers"])
    out = tclip.vision_prefix(trained, x, cfg, upto=2,
                              compute_dtype=torch.float32)
    assert out.requires_grad and calls == []
    monkeypatch.setenv("TTL_LN_STATS", "ex2")
    with torch.no_grad():
        tclip.vision_prefix(tparams, x, cfg, upto=2,
                            compute_dtype=torch.float32)
    assert calls == []
    monkeypatch.delenv("TTL_LN_STATS")
    with torch.no_grad():   # the same weights fold where grad mode is off
        tclip.vision_prefix(trained, x, cfg, upto=2,
                            compute_dtype=torch.float32)
    assert len(calls) == 8


@pytest.mark.parametrize("n_q", [2, 4])
def test_int8_prefix_layers_make_no_fused_call(tiny, monkeypatch, n_q):
    """The int8 layers keep K5's linears: only the full-precision layers
    after them fold (none where the whole prefix is int8)."""
    params, images = tiny
    tparams = tq.attach_prefix_quant(params_from_numpy(params, "cpu"), n_q)
    calls = _counting(monkeypatch)
    with torch.no_grad():
        tclip.vision_prefix(tparams["vision"], torch.from_numpy(images),
                            TEST_TINY.vision, upto=3,
                            compute_dtype=torch.float32)
    assert len(calls) == 4 * max(0, 3 - n_q)
    assert all(epi == "linear" for _, epi, _ in calls)


# ------------------------------------------------- K6's bf16 body, emulated
#
# The kernel cannot run here, so what it computes is rebuilt from what it
# writes and what wgmma reads: the x tile as TMA writes it (one box of BM
# rows a 64-column chunk) and as wgmma's K-major A descriptor reads it, with
# the 128-byte swizzle (`a_offset` in the source, where the layernorm reads
# and writes), w's slices as TMA writes them into the ring and as the
# MN-major B descriptor reads them, and the walk over row tiles, N tiles, K slices and
# k16 steps. The tile constants are read from the source, so the emulation
# follows it. Hardware side: the 128-byte swizzle XORs address bits [4, 7)
# with bits [7, 10) (TMA on write, wgmma on read); a descriptor of layout
# type 1 reads a K-major operand's 8-row atoms SBO bytes apart and an
# MN-major operand's 8 K rows SBO apart, its next 64 columns LBO apart.

K6_SOURCE = Path(tlm.__file__).resolve().parent.parent / "csrc" / \
    "ln_matmul.cu"
MAX_SMEM = 232448


def _k6_tile():
    text = K6_SOURCE.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kRowsTall", "kBN", "kWN", "kBK", "kStages")}


def _round64(k):
    return (k + 63) // 64 * 64


def _k6_smem(bm, k, c):
    """`wgmma_smem` of the source: alignment, tile, ring, barriers."""
    return (1024 + bm * _round64(k) * 2 + c["kStages"] * c["kBK"] * c["kBN"]
            * 2 + 16 * c["kStages"] + 8)


def _k6_rows(k, c):
    """The launcher's route rule: the tall tile where it and the ring fit."""
    return c["kRowsTall"] if _k6_smem(c["kRowsTall"], k, c) <= MAX_SMEM \
        else 64


def _swizzle(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def _a_store(bm, r, col):
    """Byte offset at which the kernel stores element (r, col) of the x
    tile: `a_offset(bm, r, col / 8)` plus the element's place in its unit."""
    u = col // 8
    return (u // 8) * bm * 128 + r * 128 + ((u % 8) ^ (r % 8)) * 16 \
        + (col % 8) * 2


def _a_read(bm, wg, k0):
    """Byte addresses at which wgmma reads warpgroup wg's A [64, 16] at K
    offset k0: the descriptor's start as the kernel builds it, SBO = 1024."""
    start = wg * 64 * 128 + (k0 // 64) * bm * 128 + (k0 % 64) * 2
    i = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    return _swizzle(start + (i // 8) * 1024 + (i % 8) * 128 + (k // 8) * 16
                    + (k % 8) * 2)


def _b_store(c, kr, col):
    """Byte offset in a stage at which TMA puts element (kr, col) of the
    [kBK, kBN] slice: box col / 64, each box kBK rows of 128 bytes."""
    return _swizzle((col // 64) * c["kBK"] * 128 + kr * 128 + (col % 64) * 2)


def _b_read(c, q, s):
    """Byte addresses in a stage at which wgmma q reads B [16, kWN] for the
    slice's k16 step s: LBO = one box, SBO = 1024."""
    box = c["kBK"] * 128
    start = q * (c["kWN"] // 64) * box + s * 16 * 128
    k = np.arange(16)[:, None]
    n = np.arange(c["kWN"])[None, :]
    return _swizzle(start + (n // 64) * box + (k // 8) * 1024
                    + (k % 8) * 128 + (n % 64) * 2)


def test_k6_tile_rule_and_budget():
    """BM = 128 up to K = 768 and 64 beyond; the tile, the ring and the
    barriers fit a block's shared memory at every zoo width and up to the
    largest K the bf16 route takes; every operand atom starts on 1024
    bytes."""
    c = _k6_tile()
    assert c["kBN"] % c["kWN"] == 0 and c["kWN"] % 64 == 0
    assert c["kBK"] % 16 == 0 and c["kStages"] >= 3
    for k in (48, 512, 640, 768):
        assert _k6_rows(k, c) == c["kRowsTall"]
    for k in (784, 1024, 1280, 1536):
        assert _k6_rows(k, c) == 64
        assert _k6_smem(64, k, c) <= MAX_SMEM
    assert _k6_smem(64, 1552, c) > MAX_SMEM  # ttl_ln_matmul_max_k(1) = 1536
    stage = c["kBK"] * c["kBN"] * 2
    for bm in (64, c["kRowsTall"]):
        assert (bm * 128) % 1024 == 0 and stage % 1024 == 0
        assert (c["kBK"] * 128) % 1024 == 0 or c["kBK"] == 16


@pytest.mark.parametrize("k", [48, 768, 1024])
def test_k6_a_tile_stores_are_what_wgmma_reads(k):
    """Every (row, column) of the x tile lands where TMA puts it and where
    the A descriptor of the warpgroup and k16 step that multiply it reads
    it, and the stores fill the tile without two elements on one address."""
    c = _k6_tile()
    bm, kp = _k6_rows(k, c), _round64(k)
    r = np.arange(bm)[:, None]
    col = np.arange(kp)[None, :]
    store = _a_store(bm, r, col)
    tma = _swizzle((col // 64) * bm * 128 + r * 128 + (col % 64) * 2)
    np.testing.assert_array_equal(store, tma)
    assert np.unique(store).size == bm * kp
    assert store.min() == 0 and store.max() == bm * kp * 2 - 2
    for wg in range(bm // 64):
        for k0 in range(0, kp, 16):
            np.testing.assert_array_equal(
                _a_read(bm, wg, k0),
                store[wg * 64:(wg + 1) * 64, k0:k0 + 16])


def test_k6_w_slices_are_what_wgmma_reads():
    """w [K, N] is read untransposed: TMA's element (k, n) of a slice is
    what the MN-major descriptor of wgmma q reads for (k, n - q * kWN)."""
    c = _k6_tile()
    kr = np.arange(c["kBK"])[:, None]
    col = np.arange(c["kBN"])[None, :]
    store = _b_store(c, kr, col)
    assert np.unique(store).size == c["kBK"] * c["kBN"]
    for q in range(c["kBN"] // c["kWN"]):
        for s in range(c["kBK"] // 16):
            np.testing.assert_array_equal(
                _b_read(c, q, s),
                store[16 * s:16 * (s + 1), q * c["kWN"]:(q + 1) * c["kWN"]])


def emulate_k6(x, ln_scale, ln_bias, w, b, eps=1e-5):
    """K6's bf16 body step by step, in x's dtype (f32 or bf16 values): the
    row tiles with rows past M zero, each row's statistics, the normalised
    rows written through the kernel's store map (zero columns from K to the
    next multiple of 64), each (N tile, K slice) written into its ring stage
    as TMA does (zeros past K and N), each k16 step's operands gathered
    through the A and B descriptors' read maps, f32 accumulators, the
    epilogue's f32 bias and one rounding, and only rows below M and columns
    below N stored. The order in which the kernel's blocks take the N tiles
    changes no sum, so the walk takes them in turn."""
    c = _k6_tile()
    m, k = x.shape
    n = w.shape[1]
    bm, kp = _k6_rows(k, c), _round64(k)
    tile_elems = bm * kp
    stage_elems = c["kBK"] * c["kBN"]
    rr = np.arange(bm)[:, None]
    cc = np.arange(kp)[None, :]
    a_idx = torch.from_numpy(_a_store(bm, rr, cc) // 2)
    kr = np.arange(c["kBK"])[:, None]
    bc = np.arange(c["kBN"])[None, :]
    b_idx = torch.from_numpy(_b_store(c, kr, bc) // 2)
    a_reads = {(wg, k0): torch.from_numpy(_a_read(bm, wg, k0) // 2)
               for wg in range(bm // 64) for k0 in range(0, k, 16)}
    b_reads = {(q, s): torch.from_numpy(_b_read(c, q, s) // 2)
               for q in range(c["kBN"] // c["kWN"])
               for s in range(c["kBK"] // 16)}
    out = torch.zeros(m, n, dtype=x.dtype)
    k_slices = -(-k // c["kBK"])
    for m0 in range(0, m, bm):
        tile = torch.zeros(tile_elems)
        v = torch.zeros(bm, k)
        v[:min(bm, m - m0)] = x[m0:m0 + bm].float()
        mu = v.mean(dim=-1, keepdim=True)
        var = (v - mu).square().mean(dim=-1, keepdim=True)
        h = ((v - mu) * torch.rsqrt(var + eps) * ln_scale.float()
             + ln_bias.float()).to(x.dtype).float()
        normed = torch.zeros(bm, kp)
        normed[:, :k] = h
        tile[a_idx.flatten()] = normed.flatten()
        acc = torch.zeros(bm, c["kBN"])
        for nt in range(-(-n // c["kBN"])):
            for ks in range(k_slices):
                sl = torch.zeros(c["kBK"], c["kBN"])
                part = w[ks * c["kBK"]:(ks + 1) * c["kBK"],
                         nt * c["kBN"]:(nt + 1) * c["kBN"]].float()
                sl[:part.shape[0], :part.shape[1]] = part
                stage = torch.zeros(stage_elems)
                stage[b_idx.flatten()] = sl.flatten()
                for s in range(c["kBK"] // 16):
                    k0 = ks * c["kBK"] + 16 * s
                    if k0 >= k:
                        continue
                    for wg in range(bm // 64):
                        av = tile[a_reads[wg, k0]]
                        for q in range(c["kBN"] // c["kWN"]):
                            bv = stage[b_reads[q, s]]
                            cols = slice(q * c["kWN"], (q + 1) * c["kWN"])
                            acc[wg * 64:(wg + 1) * 64, cols] += av @ bv
            n0 = nt * c["kBN"]
            n1 = min(n, n0 + c["kBN"])
            m1 = min(m, m0 + bm)
            out[m0:m1, n0:n1] = (acc[:m1 - m0, :n1 - n0]
                                 + b[n0:n1].float()).to(x.dtype)
            acc.zero_()
    return out


@pytest.mark.parametrize("m,k,n,dtype", [
    (77, 48, 80, torch.float32),       # K, N short of the tiles
    (130, 1024, 320, torch.float32),   # ViT-L/14's width, 64-row tiles
    (200, 768, 256, torch.float32),    # ragged M over 128-row tiles
    (77, 48, 80, torch.bfloat16),
])
def test_emulated_k6_matches_plain(m, k, n, dtype):
    """f32: the order of the sums only, rtol/atol 1e-5 as the plain
    version's own tests against JAX. bf16: the normalised row rounds as in
    the plain version, so only an output's own rounding may differ: one bf16
    step of the output's scale. At f32 also against JAX's
    `reference_ln_matmul`."""
    arrays = _inputs(m, k, n, seed=m + k, zero_rows=(0, m // 2))
    x, scale, bias, w, b = (torch.from_numpy(a) for a in arrays)
    x, w = x.to(dtype), w.to(dtype)
    got = emulate_k6(x, scale, bias, w, b)
    want = tlm.ln_matmul_plain(x, scale, bias, w, b)
    assert got.dtype == dtype and got.shape == (m, n)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(j_reference(*[jnp.asarray(a)
                                                  for a in arrays])),
            rtol=1e-5, atol=1e-5)
    else:
        bound = BF16_STEP * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= bound


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
@pytest.mark.parametrize("epilogue", ["f32", "linear"])
def test_k6_takes_a_transposed_weight(cuda_device, epilogue):
    """A checkpoint's weights come in [out, in] and are viewed transposed:
    `ln_matmul` gives K6 a row-major copy, the same bits as a row-major
    weight."""
    arrays = _inputs(300, 768, 768, seed=8)
    x, scale, bias, w, b = (tensor_from_numpy(a, cuda_device) for a in arrays)
    x, w = x.bfloat16(), w.bfloat16()
    viewed = w.t().contiguous().t()
    assert not viewed.is_contiguous()
    got = tlm.ln_matmul(x, scale, bias, viewed, b, epilogue=epilogue)
    want = tlm.ln_matmul(x, scale, bias, w, b, epilogue=epilogue)
    assert torch.equal(got, want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n,dtype", [
    (106496, 768, 768, torch.bfloat16),    # ViT-B/16's prefix: q, k, v
    (106496, 768, 3072, torch.bfloat16),   # and fc1
    (139264, 1024, 1024, torch.bfloat16),  # ViT-L/14's, 64-row tiles
    (139264, 1024, 4096, torch.bfloat16),
    (77, 48, 80, torch.bfloat16),          # K, N short of the tiles
    (300, 256, 384, torch.float32),
    (33, 768, 768, torch.float32),
])
def test_k6_linear_epilogue_matches_plain_on_card(cuda_device, m, k, n,
                                                  dtype, gelu):
    """The "linear" epilogue against the plain version, which on the card
    is the package's own layer_norm -> linear (-> quick_gelu) with the
    product summed in f32 (no reduced-precision reduction): only the order
    of the sums differs. At bf16 a normalised value or a product that lies
    at a rounding boundary may round the other way, which moves an output
    by at most one bf16 step at the top of the output's range (2^-7 of the
    largest, as K6's own test with its f32 epilogue); and such outputs stay
    rare, under 1 % (the f32 epilogue's single rounding moves about a
    quarter of them, so this holds the rounding points). f32: order only,
    1e-5 of the scale."""
    arrays = _inputs(m, k, n, seed=m + n, zero_rows=(0, m // 2))
    x, scale, bias, w, b = (tensor_from_numpy(a, cuda_device) for a in arrays)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    tlm.ln_matmul.launches = tlm.ln_matmul.linear_launches = 0
    got = tlm.ln_matmul(x, scale, bias, w, b, epilogue="linear",
                        quick_gelu=gelu)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = tlm.ln_matmul_plain(x, scale, bias, w, b, 1e-5, "linear",
                                   gelu).float()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    torch.cuda.synchronize()
    assert tlm.ln_matmul.launches == tlm.ln_matmul.linear_launches == 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    diff = (got.float() - want).abs()
    rel = 2 * BF16_STEP if dtype == torch.bfloat16 else 1e-5
    assert diff.max().item() <= rel * max(1.0, want.abs().max().item())
    if dtype == torch.bfloat16:
        assert (diff > 0).float().mean().item() < 0.01
