"""The int8 frozen prefix of the PyTorch port against `ttl_tpu.ops.quant`.

- `quantize_linear` and `attach_prefix_quant` equal the JAX ones leaf for
  leaf, and `quant_prefix_len` agrees per mode; on a ResNet tower both are
  no-ops, as in the JAX package.
- `linear_q_plain` equals the JAX `linear_q` bit for bit at f32: the row
  scale, the int8 codes, the exact int32 sum and the epilogue, where XLA
  fuses `acc * (s * col_scale) + b` into one fused multiply-add. At bf16
  XLA on the CPU keeps the scale and the quotient x / s in f32 (excess
  precision), so codes can differ by one; the test bounds each output by one
  quantisation step per code (see `test_linear_q_plain_bf16_within_a_step`).
- The Pallas kernel (`quantized_matmul`, interpret mode) at its own test's
  atol 1e-5.
- `encoder_layer_q` and the int8 `vision_prefix` against JAX under
  `force_mode("bshd")`. f32 sums in another order (layer norm, attention)
  can move an activation across a .5 boundary of the int8 grid; one flipped
  code moves its linear's outputs in that row by at most one quantum,
  max_t(s_t) * max|w|. The bound is 8 quanta of the widest linear per layer
  (the downstream gains of these weights stay below 8: checked); per layer,
  at least 90 % of the elements must also agree to f32 noise.
- K5's three launches emulated on the CPU (row codes and scales, the
  zero-padded K, the K-major weight, the tile walk with int32 sums per K
  step, the fragments of `mma.sync` m16n8k32) equal `linear_q_plain` bit
  for bit, and at f32 JAX's `linear_q`.
- K5 on the card equals `linear_q_plain` on the card bit for bit.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.config import TTLConfig
from ttl_tpu.models import clip as jclip
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.models.zoo import get_arch as j_get_arch
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops import quant as jq
from ttl_tpu.ops.quant_matmul import quantized_matmul
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ttl_tpu_torch.models.resnet import ResNetVisionConfig
from ttl_tpu_torch.models.zoo import TEST_TINY, get_arch
from ttl_tpu_torch.ops import quant as tq

LAYERS = TEST_TINY.vision.layers


def _linear(rng, k, n, stack=None, w_scale=0.05):
    lead = () if stack is None else (stack,)
    return {"w": (rng.standard_normal(lead + (k, n)) * w_scale).astype(
                np.float32),
            "b": rng.standard_normal(lead + (n,)).astype(np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("stack", [None, 3])
def test_quantize_linear_matches_jax(stack):
    pj, pt = _both(_linear(np.random.default_rng(0), 48, 32, stack))
    want, got = jq.quantize_linear(pj), tq.quantize_linear(pt)
    assert got["wq"].dtype == torch.int8
    assert got["scale"].dtype == torch.float32
    for leaf in ("wq", "scale", "b"):
        np.testing.assert_array_equal(got[leaf].numpy(),
                                      np.asarray(want[leaf]), err_msg=leaf)


@pytest.mark.parametrize("shape,seed", [((37, 96), 0), ((2, 21, 64), 1),
                                        ((5, 48), 2)])
def test_linear_q_plain_bit_exact_at_f32(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 5.0)).astype(np.float32)
    x[0, ...] = 0.0   # a zero row: the 1e-12 clamp, every code 0
    pj, pt = _both(_linear(rng, shape[-1], 48))
    want = np.asarray(jax.jit(jq.linear_q)(jnp.asarray(x),
                                           jq.quantize_linear(pj)))
    got = tq.linear_q_plain(torch.from_numpy(x), tq.quantize_linear(pt))
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (48,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear_q_plain_bf16_within_a_step():
    """bf16: XLA keeps s and x / s in f32, the port rounds both to bf16 as
    `linear_q` is written. So s differs by at most one bf16 rounding
    (2^-9 relative) and each code by at most one, and per output
    |dy| <= s_t * col_scale_n * sum_k |wq_kn| (every code one step off)
    + 2^-8 |acc| s col_scale (the scale's rounding) + one bf16 ulp of each
    side's output."""
    rng = np.random.default_rng(3)
    x = jnp.asarray((rng.standard_normal((37, 96)) * 2).astype(np.float32)
                    ).astype(jnp.bfloat16)
    p = _linear(rng, 96, 48)
    pj, pt = _both(p)
    qj, qt = jq.quantize_linear(pj), tq.quantize_linear(pt)
    want = np.asarray(jax.jit(jq.linear_q)(x, qj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    got = tq.linear_q_plain(xt, qt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    s = tq._row_scale(xt).float().numpy()                         # [T, 1]
    cs = qt["scale"].numpy()                                      # [N]
    wsum = np.abs(qt["wq"].numpy().astype(np.float64)).sum(0)     # [N]
    acc_mag = np.abs(got - qt["b"].numpy()) / (s * cs)            # ~|acc|
    bound = (s * cs * wsum + 2.0 ** -8 * acc_mag * s * cs
             + 2.0 ** -8 * (np.abs(got) + np.abs(want)))
    assert np.all(np.abs(got - want) <= bound)
    # not vacuous: most outputs agree far more closely than the bound
    assert np.median(np.abs(got - want) / bound) < 0.1


def test_plain_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((48, 128)).astype(np.float32)
    pj, pt = _both(_linear(rng, 128, 256))
    qj = jq.quantize_linear(pj)
    want = np.asarray(quantized_matmul(jnp.asarray(x), qj["wq"],
                                       qj["scale"][None, :], qj["b"][None, :],
                                       tm=16))
    got = tq.linear_q_plain(torch.from_numpy(x), tq.quantize_linear(pt))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_fma_f32_rounds_once():
    """Against exact rational arithmetic, ties to even, on values where a
    multiply then an add would round twice."""
    rng = np.random.default_rng(8)
    n = 1000
    a = rng.standard_normal(2 * n).astype(np.float32)
    # products near the addend (where one rounding differs from two), and
    # far below it (where the f64 sum itself is inexact)
    b = (rng.standard_normal(2 * n) * np.repeat([1.0, 1e-3], n)).astype(
        np.float32)
    c = (rng.standard_normal(2 * n) * np.repeat([1.0, 50.0], n)).astype(
        np.float32)
    got = tq.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()

    def exact(x, y, z):
        fr = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(fr))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        return min(cands, key=lambda v: (abs(Fraction(float(v)) - fr),
                                         int(v.view(np.int32)) & 1))

    want = np.array([exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    separate = a * b + c
    assert (separate != want).any()   # the case the fma exists for


def test_linear_q_takes_plain_on_cpu():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    pq = tq.quantize_linear(_both(_linear(rng, 32, 16))[1])
    tq.linear_q.launches = 0
    assert torch.equal(tq.linear_q(x, pq), tq.linear_q_plain(x, pq))
    assert tq.linear_q.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantized_matmul_cuda(x, pq["wq"], pq["scale"], pq["b"])


def test_quantize_layer_stack_refuses_fused_qkv():
    stacked = {"attn": {"qkv": {}}}
    with pytest.raises(ValueError, match="fuse_qkv"):
        tq.quantize_layer_stack(stacked, 1)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))


def _assert_same_tree(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            assert got[k].shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("upto,drop_fp", [(2, False), (2, True),
                                          (LAYERS, False), (LAYERS, True)])
def test_attach_prefix_quant_matches_jax(jparams, upto, drop_fp):
    want = jax.tree.map(np.asarray, jq.attach_prefix_quant(
        jparams, upto, drop_fp=drop_fp))
    got = tq.attach_prefix_quant(params_from_numpy(jparams, "cpu"), upto,
                                 drop_fp=drop_fp)
    assert got["vision"]["prefix_q"]["attn"]["q"]["wq"].dtype == torch.int8
    n_fp = 0 if drop_fp and upto == LAYERS else LAYERS
    assert got["vision"]["layers"]["ln1"]["scale"].shape[0] == n_fp
    _assert_same_tree(params_to_numpy(got), want)
    # the bridge carries the JAX int8 tree over leaf by leaf
    bridged = params_from_numpy(want, "cpu", param_dtype=torch.bfloat16)
    assert bridged["vision"]["prefix_q"]["mlp"]["fc1"]["wq"].dtype == \
        torch.int8
    assert bridged["vision"]["prefix_q"]["mlp"]["fc1"]["scale"].dtype == \
        torch.float32
    assert bridged["vision"]["layers"]["ln1"]["scale"].shape[0] == n_fp


@pytest.mark.parametrize("mode", [
    {}, {"lora_encoder": "text"}, {"lora_encoder": "prompt"},
    {"tta_steps": 0}, {"cocoop": True}, {"layer_range": (1, 2)}])
def test_quant_prefix_len_matches_jax(mode):
    cfg = TTLConfig(arch="test-tiny", **mode)
    assert tq.quant_prefix_len(cfg, TEST_TINY) == \
        jq.quant_prefix_len(cfg, J_TINY)


# ------------------------------------------------------ int8 layers vs JAX

def _layer_quantum(pq, x, heads, eps, seq_len):
    """max over the layer's six linears of max_t(s_t) * max|w|, with the
    port's own intermediates (max|w| = 127 * max col_scale)."""
    qs = []

    def lin(h, p):
        s = tq._row_scale(h).max().item()
        qs.append(s * 127 * p["scale"].max().item())
        return tq.linear_q_plain(h, p)

    h = tclip.layer_norm(x, pq["ln1"], eps)
    q, k, v = (lin(h, pq["attn"][n]) for n in "qkv")
    a = tclip.attention(q, k, v, heads, False, seq_len)
    x = x + lin(a, pq["attn"]["o"])
    h = tclip.layer_norm(x, pq["ln2"], eps)
    lin(tclip.quick_gelu(lin(h, pq["mlp"]["fc1"])), pq["mlp"]["fc2"])
    return max(qs)


def _assert_int8_close(got, want, quantum, n_layers=1, agree=None):
    """max |diff| within f32 noise plus 8 quanta per layer; with `agree`,
    at least that share of the elements within f32 noise alone (a flipped
    code moves one row, or through attention one image's rows)."""
    scale = max(1.0, float(np.abs(want).max()))
    diff = np.abs(got - want)
    assert diff.max() <= 1e-5 * scale + 8 * n_layers * quantum, \
        (diff.max(), quantum)
    if agree is not None:
        assert np.mean(diff <= 1e-5 * scale) >= agree


@pytest.fixture(scope="module")
def qsetup(jparams):
    qj = jax.tree.map(np.asarray, jq.attach_prefix_quant(jparams, LAYERS))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    return qj, params_from_numpy(qj, "cpu"), images


def test_downstream_gains_of_test_weights_stay_below_eight(qsetup):
    """The premise of the 8-quanta bound: a perturbation of one row of a
    linear's input grows by at most ||W||_1 (max column abs sum) through it;
    for every linear of these weights that is below 8 (QuickGELU's slope is
    below 1.13)."""
    _, tp, _ = qsetup
    for group, names in tq.LINEARS.items():
        for n in names:
            p = tp["vision"]["prefix_q"][group][n]
            w = p["wq"].float() * p["scale"][:, None, :]
            assert 1.13 * w.abs().sum(dim=-2).max().item() < 8, (group, n)


def test_encoder_layer_q_matches_jax_per_layer(qsetup):
    """Each int8 layer fed the JAX side's own input hidden state."""
    qj, tp, images = qsetup
    vcfg = J_TINY.vision
    with jfa.force_mode("bshd"):
        h = np.asarray(jax.jit(lambda p, x: jclip.vision_prefix(
            p, x, vcfg, upto=0, compute_dtype=jnp.float32))(
                qj["vision"], images))
        layer_fn = jax.jit(lambda lp, x: jclip.encoder_layer_q(
            lp, x, heads=vcfg.heads, eps=vcfg.ln_eps, causal=False,
            seq_len=vcfg.seq_len))
        for i in range(LAYERS):
            lj = jax.tree.map(lambda a: a[i], qj["vision"]["prefix_q"])
            want = np.asarray(layer_fn(lj, h))
            lt = tclip.layer_at(tp["vision"]["prefix_q"], i)
            x = torch.from_numpy(np.array(h))
            got = tclip.encoder_layer_q(lt, x, heads=vcfg.heads,
                                        eps=vcfg.ln_eps,
                                        seq_len=vcfg.seq_len).numpy()
            quantum = _layer_quantum(lt, x, vcfg.heads, vcfg.ln_eps,
                                     vcfg.seq_len)
            real = slice(0, vcfg.seq_len)
            _assert_int8_close(got[:, real], want[:, real], quantum,
                               agree=0.9)
            h = want


@pytest.mark.parametrize("upto", [2, LAYERS])
def test_int8_vision_prefix_matches_jax(qsetup, jparams, upto):
    """prefix_q layers then fp layers (upto < n_q reads only the first upto
    int8 layers); the whole tower with the fp stack dropped."""
    qj, tp, images = qsetup
    if upto < LAYERS:
        qj = jax.tree.map(np.asarray, jq.attach_prefix_quant(jparams, 1))
        tp = params_from_numpy(qj, "cpu")
    with jfa.force_mode("bshd"):
        want = np.asarray(jax.jit(lambda p, x: jclip.vision_prefix(
            p, x, J_TINY.vision, upto=upto, compute_dtype=jnp.float32))(
                qj["vision"], images))
    got = tclip.vision_prefix(tp["vision"], torch.from_numpy(images),
                              TEST_TINY.vision, upto=upto,
                              compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (3, 32, 32)
    x = tclip.vision_prefix(tp["vision"], torch.from_numpy(images),
                            TEST_TINY.vision, upto=0,
                            compute_dtype=torch.float32)
    nq = tp["vision"]["prefix_q"]["ln1"]["scale"].shape[0]
    quanta = []
    for i in range(min(upto, nq)):
        lt = tclip.layer_at(tp["vision"]["prefix_q"], i)
        quanta.append(_layer_quantum(lt, x, 2, 1e-5, 17))
        x = tclip.encoder_layer_q(lt, x, heads=2, eps=1e-5, seq_len=17)
    _assert_int8_close(got[:, :17], want[:, :17], max(quanta),
                       n_layers=upto)


@pytest.mark.parametrize("mode", [{}, {"tta_steps": 0},
                                  {"lora_encoder": "prompt"}])
def test_int8_prefix_is_a_no_op_on_a_resnet_tower(mode):
    """`--prefix_quant int8` on RN50 (a tiny tower of its kind): no layer to
    quantise, the params returned as they are, as in the JAX package."""
    cfg = TTLConfig(arch="RN50", prefix_quant="int8", **mode)
    assert tq.quant_prefix_len(cfg, get_arch("RN50")) == \
        jq.quant_prefix_len(cfg, j_get_arch("RN50")) == 0
    tiny = ResNetVisionConfig(layers=(1, 1, 1, 1), width=16, heads=4,
                              proj_dim=16, image_size=64)
    params = tclip.init_clip_params(
        tclip.CLIPConfig(vision=tiny, text=TEST_TINY.text),
        torch.Generator().manual_seed(0), device="cpu")
    assert tq.attach_prefix_quant(params, 4, drop_fp=True) is params
    jparams = params_to_numpy(params)
    assert jq.attach_prefix_quant(jparams, 4, drop_fp=True) is jparams


# --------------------------------------- K5's launches, emulated on the CPU
#
# csrc/quant_matmul.cu runs (Q) one pass per row of x into its scale and
# int8 codes xq [T, Kp], (W) wq copied to wt [N, Kp], K-major, and (G) the
# product over 128 x 128 output tiles in 128-byte K steps, int32 sums, with
# the epilogue fused. The emulation below follows those steps on the CPU: what
# the kernel's arithmetic, padding and tile walk give, the plain version
# must give too.

K_STEP = 128  # csrc/quant_matmul.cu kBK: the ring's K step and Kp's
TILE_M = 128  # the BM of (G)'s launch
TILE_N = 128  # kBN


def _bf16(v):
    return v.bfloat16().float()


def emulate_k5_quant_rows(x):
    """(Q): per row the f32 absmax, the row scale and quotient as the
    kernel's `Num<T>` forms them, the codes padded with zeros to Kp."""
    t, k = x.shape
    kp = -(-k // K_STEP) * K_STEP
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    inv127 = torch.ones(()) / 127
    if x.dtype == torch.bfloat16:
        s = _bf16(torch.maximum(amax, _bf16(torch.tensor(1e-12)))
                  * _bf16(inv127))
        quot = _bf16(xf / s[:, None])
    else:
        s = torch.maximum(amax, torch.tensor(1e-12)) * inv127
        quot = xf / s[:, None]
    xq = torch.zeros(t, kp, dtype=torch.int8)
    xq[:, :k] = torch.clamp(torch.round(quot), -127, 127).to(torch.int8)
    return xq, s


def emulate_k5_transpose_w(wq, kp):
    """(W): wq [K, N] to wt [N, Kp], zero past K."""
    wt = torch.zeros(wq.shape[1], kp, dtype=torch.int8)
    wt[:, :wq.shape[0]] = wq.T
    return wt


def emulate_k5(x, pq, bm=TILE_M):
    """K5 on the CPU: (Q), (W), then (G) block by block. Rows past T and
    columns past N re-read the last one, as the kernel's clamped loads do,
    and are never stored; each 64-byte K step adds an exact int32 product."""
    t, n = x.shape[0], pq["wq"].shape[1]
    xq, s = emulate_k5_quant_rows(x)
    kp = xq.shape[1]
    wt = emulate_k5_transpose_w(pq["wq"], kp)
    b = pq.get("b", torch.zeros(n))
    y = torch.full((t, n), float("nan"), dtype=x.dtype)
    for t0 in range(0, t, bm):
        rows = torch.clamp(torch.arange(t0, t0 + bm), max=t - 1)
        for n0 in range(0, n, TILE_N):
            cols = torch.clamp(torch.arange(n0, n0 + TILE_N), max=n - 1)
            acc = torch.zeros(bm, TILE_N, dtype=torch.int32)
            for k0 in range(0, kp, K_STEP):
                acc += (xq[rows, k0:k0 + K_STEP].int()
                        @ wt[cols, k0:k0 + K_STEP].int().T)
            step = s[rows][:, None] * pq["scale"][cols][None, :]
            out = tq.fma_f32(acc.float(), step,
                             b[cols][None, :].expand(bm, -1)).to(x.dtype)
            nr, nc = min(bm, t - t0), min(TILE_N, n - n0)
            y[t0:t0 + nr, n0:n0 + nc] = out[:nr, :nc]
    return y


def _k5_case(t, k, n, dtype, seed, zero_rows=(1,)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, k)) * rng.uniform(0.1, 5.0)).astype(
        np.float32)
    for r in zero_rows:
        if r < t:
            x[r] = 0.0   # the 1e-12 clamp, every code 0
    p = _linear(rng, k, n)
    return x, p, torch.from_numpy(x).to(dtype), tq.quantize_linear(
        _both(p)[1])


@pytest.mark.parametrize("t,k,n,dtype", [
    (37, 96, 48, torch.float32),      # one ragged tile each way
    (200, 80, 144, torch.bfloat16),   # two row blocks, N past a tile
    (300, 48, 272, torch.float32),    # ragged row blocks, K < one step
    (1, 16, 16, torch.bfloat16),      # one row, the smallest K and N
    (70, 160, 208, torch.bfloat16),   # K past one step, N = 16 x 13
])
def test_k5_emulation_matches_plain(t, k, n, dtype):
    x, _, xt, pq = _k5_case(t, k, n, dtype, seed=t + k, zero_rows=(1, t - 1))
    got = emulate_k5(xt, pq)
    want = tq.linear_q_plain(xt, pq)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_emulation_quant_rows_and_weight(dtype):
    """(Q)'s scales and codes are the plain version's, the tail past K is
    zero codes; (W)'s wt is wq transposed, zero past K."""
    _, _, xt, pq = _k5_case(21, 80, 32, dtype, seed=4)
    xq, s = emulate_k5_quant_rows(xt)
    assert xq.shape == (21, K_STEP)
    plain_s = tq._row_scale(xt)
    assert torch.equal(s, plain_s.float()[:, 0])
    plain_q = torch.clamp(torch.round((xt / plain_s).float()), -127, 127)
    assert torch.equal(xq[:, :80].float(), plain_q)
    assert not xq[:, 80:].any() and not xq[1].any()
    wt = emulate_k5_transpose_w(pq["wq"], K_STEP)
    assert torch.equal(wt[:, :80], pq["wq"].T) and not wt[:, 80:].any()


def test_k5_emulation_matches_jax_and_pallas_at_f32():
    """At f32 the emulated kernel equals JAX's `linear_q` bit for bit, and
    the Pallas kernel (interpret mode; it divides by 127 where `linear_q`
    multiplies by 1/127) within its own test's atol."""
    x, p, xt, pq = _k5_case(48, 128, 272, torch.float32, seed=11)
    pj = _both(p)[0]
    qj = jq.quantize_linear(pj)
    got = emulate_k5(xt, pq).numpy()
    want = np.asarray(jax.jit(jq.linear_q)(jnp.asarray(x), qj))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(quantized_matmul(jnp.asarray(x), qj["wq"],
                                         qj["scale"][None, :],
                                         qj["b"][None, :], tm=16))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


def _ldmatrix_x4(tile, lane_addr):
    """ldmatrix.x4 over a byte tile: lane l names (row, byte) of row l % 8
    of 8 x 16-byte block l // 8; register m of lane l gets bytes
    4 (l % 4) .. + 3 of row l // 4 of block m, as an int8 [4]."""
    regs = np.zeros((32, 4, 4), np.int8)
    for m in range(4):
        for lane in range(32):
            row, col = lane_addr[8 * m + lane // 4]
            regs[lane, m] = tile[row, col + 4 * (lane % 4):
                                 col + 4 * (lane % 4) + 4]
    return regs


def _mma_m16n8k32(acc, a, b0, b1):
    """mma.sync m16n8k32 s8 in PTX's fragment layout, g = lane / 4,
    q = lane % 4: A a0 (g, 4q..) a1 (g+8, 4q..) a2 (g, 16+4q..) a3 (g+8,
    16+4q..); B b0 (k 4q.., n g) b1 (k 16+4q.., n g); C c0 c1 (g, 2q, 2q+1)
    c2 c3 (g+8, 2q, 2q+1)."""
    am = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for reg, (r, c) in enumerate([(g, 4 * q), (g + 8, 4 * q),
                                      (g, 16 + 4 * q), (g + 8, 16 + 4 * q)]):
            am[r, c:c + 4] = a[lane, reg]
        bm[4 * q:4 * q + 4, g] = b0[lane]
        bm[16 + 4 * q:16 + 4 * q + 4, g] = b1[lane]
    cm = am @ bm
    for lane in range(32):
        g, q = divmod(lane, 4)
        acc[lane] += [cm[g, 2 * q], cm[g, 2 * q + 1], cm[g + 8, 2 * q],
                      cm[g + 8, 2 * q + 1]]


@pytest.mark.parametrize("bm,warps_m,warps_n", [
    (TILE_M, 2, 2),   # the launch's tile
    (64, 2, 4),       # another the template takes
])
def test_k5_fragment_walk_covers_the_tile(bm, warps_m, warps_n):
    """k5_gemm_kernel's lane addresses for ldmatrix_x4 on both operands, the
    mma_s8 fragments they make, and the epilogue's (row, column) of every
    accumulator, over one K step: each output of the BM x 128 tile is
    written once and equals the tile's int8 product."""
    rng = np.random.default_rng(bm)
    a = rng.integers(-127, 128, (bm, K_STEP), dtype=np.int8)
    b = rng.integers(-127, 128, (TILE_N, K_STEP), dtype=np.int8)
    rows, cols = bm // warps_m, TILE_N // warps_n   # a warp's tile
    mi, nj = rows // 16, cols // 8
    out = np.zeros((bm, TILE_N), np.int64)
    written = np.zeros((bm, TILE_N), np.int64)
    for warp in range(warps_m * warps_n):
        wm, wn = divmod(warp, warps_n)
        acc = np.zeros((mi, nj, 32, 4), np.int64)
        for kk in range(0, K_STEP, 32):
            af = [_ldmatrix_x4(a, [(wm * rows + i * 16 + lane % 16,
                                    kk + (lane // 16) * 16)
                                   for lane in range(32)])
                  for i in range(mi)]
            bf = [_ldmatrix_x4(b, [(wn * cols + (lane // 16) * 8 + lane % 8
                                    + p * 16, kk + ((lane // 8) % 2) * 16)
                                   for lane in range(32)])
                  for p in range(nj // 2)]
            for i in range(mi):
                for j in range(nj):
                    _mma_m16n8k32(acc[i, j], af[i], bf[j // 2][:, (j % 2) * 2],
                                  bf[j // 2][:, (j % 2) * 2 + 1])
        for lane in range(32):
            g, q = divmod(lane, 4)
            for i in range(mi):
                for hr in range(2):
                    r = wm * rows + i * 16 + g + 8 * hr
                    for j in range(nj):
                        for h in range(2):
                            c = wn * cols + j * 8 + 2 * q + h
                            out[r, c] = acc[i, j, lane, 2 * hr + h]
                            written[r, c] += 1
    assert (written == 1).all()
    np.testing.assert_array_equal(out, a.astype(np.int64) @ b.T.astype(
        np.int64))


# ------------------------------------------------- K5 (needs the card)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,n,dtype", [
    (200, 768, 768, torch.bfloat16),     # T not a multiple of 64
    (64, 768, 3072, torch.bfloat16),
    (333, 3072, 768, torch.bfloat16),
    (130, 768, 768, torch.float32),
    (7, 48, 80, torch.float32),          # K, N not multiples of the tiles
    (1, 768, 768, torch.bfloat16),       # one row
    (50, 16, 64, torch.bfloat16),        # K = 16: one K step, mostly zeros
    (70, 80, 112, torch.float32),        # K = 80: not a multiple of 32
    (40, 96, 16, torch.bfloat16),        # N = 16: one eighth of a tile
    (300, 768, 784, torch.bfloat16),     # N = 784: not a multiple of 128
    (1664, 768, 768, torch.bfloat16),    # zero-shot's rows
])
def test_k5_matches_plain_on_card(cuda_device, t, k, n, dtype):
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32)
                         * 3).to(cuda_device, dtype)
    if t > 1:
        x[1] = 0   # the 1e-12 clamp
    pq = tq.quantize_linear({
        "w": torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                              * 0.05).to(cuda_device),
        "b": torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
            cuda_device)})
    tq.linear_q.launches = 0
    got = tq.linear_q(x, pq)
    want = tq.linear_q_plain(x, pq)
    torch.cuda.synchronize()
    assert tq.linear_q.launches == 1
    assert got.dtype == dtype and got.shape == (t, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_rows_of_zeros_on_card(cuda_device, dtype):
    """Rows of zeros (scale 1e-12 * (1/127), every code 0, y = b) at the
    first row, inside a tile and as the last, ragged row."""
    rng = np.random.default_rng(5)
    t, k, n = 131, 256, 144
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32)).to(
        cuda_device, dtype)
    x[[0, 64, t - 1]] = 0
    pq = tq.quantize_linear({
        "w": torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                              * 0.05).to(cuda_device),
        "b": torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
            cuda_device)})
    got = tq.linear_q(x, pq)
    want = tq.linear_q_plain(x, pq)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[[0, 64, t - 1]].float(),
                       pq["b"].to(dtype).float().expand(3, -1))
