"""bshd attention of the PyTorch port against the JAX package's Pallas kernel.

`attention_bshd_plain` (the CPU path and the oracle of the CUDA kernels) is
held against `ttl_tpu.ops.attention.attention_bshd_fused`, which runs the
Pallas kernels in interpret mode on the CPU. Inputs are made with numpy.
Tolerances: forward rtol/atol 2e-5 and VJP rtol 2e-4 / atol 2e-5 at f32,
the bounds of the JAX package's own kernel tests (f32 sums in another
order). The CUDA kernel cases run only where a card is present; they cover
every route: bf16 on the tensor-core bodies of `csrc/attention_mma.cuh`
(emulated tile by tile below, on the CPU), f32 on the FMA routes, the
key-tiled ones at ViT-L/14@336px's 592 tokens included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.ops import attention as jfa
from ttl_tpu_torch.ops import _build
from ttl_tpu_torch.ops import attention as tfa

CASES = [
    # (B, S, heads, head_dim, seq_len)
    (2, 37, 2, 16, None),    # odd S, nothing masked
    (2, 32, 3, 16, 17),      # tower pre-padded: 17 real tokens of 32
    (1, 48, 4, 8, 45),       # four heads, 3 pad keys
    (3, 16, 1, 32, None),    # one head, tile-aligned
]


def _inputs(b, s, h, d, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h * d)).astype(np.float32)
            for _ in range(n)]


def _jax_attention(q, k, v, h, seq_len):
    return jfa.attention_bshd_fused(q, k, v, h, False, seq_len)


@pytest.mark.parametrize("b,s,h,d,seq_len", CASES)
def test_plain_forward_matches_pallas(b, s, h, d, seq_len):
    q, k, v = _inputs(b, s, h, d)
    want = np.asarray(_jax_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), h, seq_len))
    got = tfa.attention_bshd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), h, seq_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,s,h,d,seq_len", CASES)
def test_plain_vjp_matches_pallas(b, s, h, d, seq_len):
    q, k, v, do = _inputs(b, s, h, d, seed=1, n=4)
    _, vjp = jax.vjp(lambda q, k, v: _jax_attention(q, k, v, h, seq_len),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    tfa.attention_bshd_plain(tq, tk, tv, h, seq_len).backward(
        torch.from_numpy(do))
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=f"d{name}")


def test_dispatcher_takes_plain_on_cpu():
    q, k, v = (torch.from_numpy(t) for t in _inputs(2, 32, 2, 16))
    tfa.reset_launch_counts()
    out = tfa.attention_bshd(q, k, v, 2, 17)
    assert torch.equal(out, tfa.attention_bshd_plain(q, k, v, 2, 17))
    assert tfa.attention_bshd.fwd_launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 16, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.bshd_forward_cuda(q, k, v, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.bshd_backward_cuda(q, k, v, q, 2, 16)


def test_kernel_error_raises_with_the_cuda_message(monkeypatch):
    """Every geometry has a route that fits shared memory, so an error code
    from an entry point is a fault: it raises with CUDA's own message."""
    class FakeLibrary:
        @staticmethod
        def ttl_cuda_error_string(code):
            return f"error {code}".encode()

    monkeypatch.setattr(_build, "library", lambda: FakeLibrary)
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match=r"bshd attention failed: CUDA "
                       r"error 1 \(error 1\)"):
        _build.check(1, "bshd attention")


def test_causal_plain_matches_einsum_reference():
    """The text tower's attention: the JAX einsum route at f32."""
    b, s, h, d = 2, 21, 2, 16
    q, k, v = _inputs(b, s, h, d, seed=2)

    def split(t):
        return jnp.asarray(t).reshape(b, s, h, d).transpose(0, 2, 1, 3)

    want = jfa.reference_attention(split(q), split(k), split(v), True)
    want = np.asarray(want.transpose(0, 2, 1, 3).reshape(b, s, h * d))
    got = tfa.causal_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------- kernels (need the card)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bshd kernels run only there")
    return torch.device("cuda")


KERNEL_CASES = [
    # (B, S, heads, head_dim, seq_len, dtype, fwd bound, bwd bound)
    # f32: sums in another order only
    (3, 37, 2, 32, 37, torch.float32, 1e-5, 1e-4),
    (2, 208, 12, 64, 197, torch.float32, 1e-5, 1e-4),
    # bf16: the plain version's autograd rounds its bf16 intermediates,
    # the kernel keeps f32 -> a few bf16 ulps of the largest gradient
    (8, 208, 12, 64, 197, torch.bfloat16, 1e-2, 2e-2),
    (3, 37, 2, 32, 30, torch.bfloat16, 1e-2, 2e-2),
    # ViT-L/14's 272 tokens, and 304
    (2, 272, 4, 64, 257, torch.bfloat16, 1e-2, 2e-2),
    (2, 304, 4, 64, 290, torch.bfloat16, 1e-2, 2e-2),
    # ViT-L/14@336px (577 tokens padded to 592) in both dtypes, ViT-L/14
    # (257 padded to 272) in the f32 backward: the key-tiled routes of f32
    (2, 592, 16, 64, 577, torch.float32, 1e-5, 1e-4),
    (2, 592, 16, 64, 577, torch.bfloat16, 1e-2, 2e-2),
    (2, 272, 16, 64, 257, torch.float32, 1e-5, 1e-4),
    (2, 272, 16, 64, 257, torch.bfloat16, 1e-2, 2e-2),
    (1, 100, 2, 32, 70, torch.float32, 1e-5, 1e-4),   # ragged last tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,seq_len,dtype,fwd_tol,bwd_tol",
                         KERNEL_CASES)
def test_kernels_match_plain_on_card(cuda_device, b, s, h, d, seq_len, dtype,
                                     fwd_tol, bwd_tol):
    q, k, v, do = (torch.from_numpy(t).to(cuda_device, dtype)
                   for t in _inputs(b, s, h, d, seed=3, n=4))
    out = tfa.bshd_forward_cuda(q, k, v, h, seq_len)
    ref = tfa.attention_bshd_plain(q, k, v, h, seq_len)
    torch.cuda.synchronize()
    err = (out.float() - ref.float())[:, :seq_len].abs().max().item()
    assert err <= fwd_tol * max(1.0, ref.float().abs().max().item())

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.attention_bshd_plain(*leaves, h, seq_len).backward(do)
    grads = tfa.bshd_backward_cuda(q, k, v, do, h, seq_len)
    torch.cuda.synchronize()
    for got, leaf in zip(grads, leaves):
        want = leaf.grad.float()
        assert torch.isfinite(got).all()
        err = (got.float() - want)[:, :seq_len].abs().max().item()
        assert err <= bwd_tol * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("backward,dtype,s,route", [
    (False, torch.bfloat16, 208, "tensor cores"),     # ViT-B/16
    (True, torch.bfloat16, 208, "tensor cores"),
    (False, torch.bfloat16, 64, "tensor cores"),      # ViT-B/32
    (True, torch.bfloat16, 64, "tensor cores"),
    (False, torch.float32, 208, "key-tiled FMA"),     # every f32 forward
    (True, torch.float32, 208, "whole-head FMA"),
    (False, torch.bfloat16, 272, "tensor cores"),     # ViT-L/14
    (True, torch.bfloat16, 272, "tensor cores"),
    (True, torch.float32, 272, "key-tiled FMA"),
    (False, torch.bfloat16, 592, "tensor cores"),     # ViT-L/14@336px
    (True, torch.bfloat16, 592, "tensor cores"),
    (True, torch.float32, 592, "key-tiled FMA"),
])
def test_kernel_route_per_geometry(cuda_device, backward, dtype, s, route):
    """bf16 on the tensor cores at every S; f32 on the FMA routes: the
    key-tiled forward, and the whole-head backward where it fits shared
    memory."""
    assert tfa.kernel_route(backward, dtype, s, 64) == route


@pytest.mark.cuda
def test_autograd_function_counts_launches(cuda_device):
    q, k, v = (torch.from_numpy(t).to(cuda_device).requires_grad_(True)
               for t in _inputs(2, 32, 2, 16, seed=4))
    tfa.reset_launch_counts()
    tfa.attention_bshd(q, k, v, 2, 17).sum().backward()
    assert (tfa.attention_bshd.fwd_launches,
            tfa.attention_bshd.bwd_launches) == (1, 1)


# ------------------------------------- K3 (per_head) and K4 (heads), [B,H,S,D]
#
# `attention_bhsd_plain` is the plain version of both kernels. It is held
# against `fused_attention` / `attention` (K3's Pallas functions) and
# `attention_heads` (K4's), which run in interpret mode here. f32: forward
# and VJP within 1e-5 (sums in another order). bf16: the forward within one
# bf16 ulp of the output's scale (2^-8 relative, both round P and the output
# to bf16); the VJP within 2^-6 of the largest gradient (autograd through the
# plain version rounds its bf16 intermediates, the Pallas backward keeps
# f32).

BHSD_CASES = [
    # (B, H, S, D, causal)
    (2, 2, 16, 16, True),     # text, tile-aligned
    (2, 3, 21, 16, True),     # odd S, causal
    (1, 2, 37, 32, False),    # vision, odd S
    (2, 4, 48, 8, True),
    (3, 1, 16, 32, False),
]
JAX_BHSD = {"per_head": jfa.attention, "heads": jfa.attention_heads}


def _bhsd_inputs(b, h, s, d, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("route", ["per_head", "heads"])
@pytest.mark.parametrize("b,h,s,d,causal", BHSD_CASES)
def test_bhsd_plain_forward_matches_pallas(route, b, h, s, d, causal):
    q, k, v = _bhsd_inputs(b, h, s, d, seed=5)
    want = np.asarray(JAX_BHSD[route](jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal))
    got = tfa.attention_bhsd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bhsd_plain_forward_matches_fused_attention():
    q, k, v = _bhsd_inputs(2, 2, 21, 16, seed=6)
    want = np.asarray(jfa.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=True))
    got = tfa.attention_bhsd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["per_head", "heads"])
@pytest.mark.parametrize("b,h,s,d,causal", BHSD_CASES)
def test_bhsd_plain_vjp_matches_pallas(route, b, h, s, d, causal):
    q, k, v, do = _bhsd_inputs(b, h, s, d, seed=7, n=4)
    _, vjp = jax.vjp(lambda q, k, v: JAX_BHSD[route](q, k, v, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    tfa.attention_bhsd_plain(tq, tk, tv, causal).backward(
        torch.from_numpy(do))
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("route", ["per_head", "heads"])
@pytest.mark.parametrize("causal", [True, False])
def test_bhsd_plain_bf16_matches_pallas(route, causal):
    b, h, s, d = 2, 2, 32, 16
    q, k, v, do = (jnp.asarray(t).astype(jnp.bfloat16)
                   for t in _bhsd_inputs(b, h, s, d, seed=8, n=4))
    out, vjp = jax.vjp(lambda q, k, v: JAX_BHSD[route](q, k, v, causal),
                       q, k, v)
    want = vjp(do)

    def to_torch(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)

    tq, tk, tv = (to_torch(t).requires_grad_(True) for t in (q, k, v))
    got = tfa.attention_bhsd_plain(tq, tk, tv, causal)
    got.backward(to_torch(do))
    ref = np.asarray(out.astype(jnp.float32))
    err = np.abs(got.detach().float().numpy() - ref).max()
    assert err <= 2.0 ** -8 * max(1.0, np.abs(ref).max())
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2.0 ** -6 * np.abs(w).max(), f"d{name}: {err}"


@pytest.mark.parametrize("wrapper", ["attention_per_head", "attention_heads"])
def test_bhsd_dispatchers_take_plain_on_cpu(wrapper):
    q, k, v = (torch.from_numpy(t) for t in _bhsd_inputs(2, 2, 21, 16))
    tfa.reset_launch_counts()
    fn = getattr(tfa, wrapper)
    assert torch.equal(fn(q, k, v, True),
                       tfa.attention_bhsd_plain(q, k, v, True))
    assert (fn.fwd_launches, fn.bwd_launches) == (0, 0)


@pytest.mark.parametrize("launch", ["per_head_forward_cuda",
                                    "heads_forward_cuda"])
def test_bhsd_kernel_wrappers_refuse_cpu_tensors(launch):
    q, k, v = (torch.from_numpy(t) for t in _bhsd_inputs(1, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tfa, launch)(q, k, v, True)


# ---------------------------------------------------------- the route switch

@pytest.mark.parametrize("value,mode", [
    ("", "bshd"), ("bshd", "bshd"), ("1", "per_head"), ("true", "per_head"),
    ("True", "per_head"), ("per_head", "per_head"), ("heads", "heads"),
    ("0", ""), ("off", ""), ("xla", ""), ("einsum", "")])
def test_fused_mode_reads_the_environment(monkeypatch, value, mode):
    monkeypatch.setenv("TTL_FUSED_ATTENTION", value)
    tfa.reset_mode()
    try:
        assert tfa.fused_mode() == mode
        with tfa.force_mode("heads"):
            assert tfa.fused_mode() == "heads"
    finally:
        tfa.reset_mode()


def test_unknown_fused_mode_raises(monkeypatch):
    """The JAX package falls back silently; the port raises."""
    monkeypatch.setenv("TTL_FUSED_ATTENTION", "flash")
    tfa.reset_mode()
    try:
        with pytest.raises(ValueError, match="TTL_FUSED_ATTENTION='flash'"):
            tfa.fused_mode()
    finally:
        monkeypatch.delenv("TTL_FUSED_ATTENTION")
        tfa.reset_mode()
    with pytest.raises(ValueError, match="unknown attention route"):
        tfa.force_mode("flash")


@pytest.mark.parametrize("mode", ["per_head", "heads", ""])
def test_seq_len_needs_the_bshd_route(mode):
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 32, 2, 16))
    with tfa.force_mode(mode), pytest.raises(ValueError, match="bshd route"):
        tfa.attention(q, k, v, 2, False, seq_len=17)


@pytest.mark.parametrize("mode", ["bshd", "per_head", "heads", ""])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_dispatch_matches_jax_dispatch(mode, causal):
    """`attention` against `ttl_tpu.models.clip._attention` under the same
    forced route, f32, rtol/atol 2e-5."""
    from ttl_tpu.models import clip as jclip
    b, s, h, d = 2, 32, 2, 16
    q, k, v = _inputs(b, s, h, d, seed=9)
    with jfa.force_mode(mode):
        want = np.asarray(jclip._attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), h, causal))
    with tfa.force_mode(mode):
        got = tfa.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), h, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# --------------------------------------------- K3/K4 kernels (need the card)

BHSD_KERNEL_CASES = [
    # (B, H, S, D, causal, dtype, fwd bound, bwd bound)
    (3, 8, 16, 64, True, torch.float32, 1e-5, 1e-4),
    (3, 8, 32, 64, True, torch.bfloat16, 1e-2, 2e-2),
    (2, 8, 48, 64, True, torch.float32, 1e-5, 1e-4),
    (2, 12, 64, 64, True, torch.bfloat16, 1e-2, 2e-2),
    (2, 12, 80, 64, True, torch.float32, 1e-5, 1e-4),
    (2, 8, 77, 64, True, torch.bfloat16, 1e-2, 2e-2),    # untruncated table
    (2, 12, 197, 64, False, torch.float32, 1e-5, 1e-4),  # ViT-B/16
    (4, 12, 197, 64, False, torch.bfloat16, 1e-2, 2e-2),
    (2, 16, 257, 64, False, torch.bfloat16, 1e-2, 2e-2),  # ViT-L/14
    (2, 12, 50, 64, False, torch.float32, 1e-5, 1e-4),   # ViT-B/32
    (1, 16, 577, 64, False, torch.bfloat16, 1e-2, 2e-2),  # ViT-L/14@336px
    (1, 16, 577, 64, False, torch.float32, 1e-5, 1e-4),
    (2, 2, 21, 16, True, torch.float32, 1e-5, 1e-4),     # the tiny configs
    (2, 2, 37, 32, False, torch.bfloat16, 1e-2, 2e-2),
    (1, 2, 100, 32, True, torch.float32, 1e-5, 1e-4),    # causal tile skips
    (1, 1, 1, 16, True, torch.float32, 1e-5, 1e-4),      # one token
]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["per_head", "heads"])
@pytest.mark.parametrize("b,h,s,d,causal,dtype,fwd_tol,bwd_tol",
                         BHSD_KERNEL_CASES)
def test_bhsd_kernels_match_plain_on_card(cuda_device, route, b, h, s, d,
                                          causal, dtype, fwd_tol, bwd_tol):
    forward = getattr(tfa, f"{route}_forward_cuda")
    backward = getattr(tfa, f"{route}_backward_cuda")
    q, k, v, do = (torch.from_numpy(t).to(cuda_device, dtype)
                   for t in _bhsd_inputs(b, h, s, d, seed=10, n=4))
    out = forward(q, k, v, causal)
    ref = tfa.attention_bhsd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= fwd_tol * max(1.0, ref.float().abs().max().item())

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.attention_bhsd_plain(*leaves, causal).backward(do)
    grads = backward(q, k, v, do, causal)
    torch.cuda.synchronize()
    for got, leaf in zip(grads, leaves):
        want = leaf.grad.float()
        assert torch.isfinite(got).all()
        err = (got.float() - want).abs().max().item()
        assert err <= bwd_tol * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,wrapper", [("per_head", "attention_per_head"),
                                          ("heads", "attention_heads")])
def test_bhsd_autograd_functions_count_launches(cuda_device, mode, wrapper):
    q, k, v = (torch.from_numpy(t).to(cuda_device).requires_grad_(True)
               for t in _inputs(2, 32, 2, 16, seed=11))
    tfa.reset_launch_counts()
    with tfa.force_mode(mode):
        tfa.attention(q, k, v, 2, True).sum().backward()
    fn = getattr(tfa, wrapper)
    assert (fn.fwd_launches, fn.bwd_launches) == (1, 1)
    assert tfa.attention_bshd.fwd_launches == 0


# ------------------- the tensor-core bodies of K3/K4, emulated tile by tile
#
# `csrc/attention_mma.cuh` cannot run here. Its arithmetic can: the functions
# below repeat it in plain PyTorch, tile by tile as the kernels walk a head.
# 16 query rows (or keys) a warp, blocks of 32, 64 or 128 rows, the other
# side in stages of 32 or 64 rows (`_mma_tiles`);
# the forward's online softmax against the running max with P rounded to
# bf16 before P.V (normalised first where the block has one stage); the
# backward's rows sweep (e, dP shifted by its value at
# key 0, A and B rescaled by alpha, dQ = scale (A - rs B) / l) and keys sweep
# (P and dS from the rows' statistics), whose f32 factors enter each product
# as two bf16 terms hi + lo; with the causal mask, stages and 16-row blocks
# wholly on the masked side are skipped. Products of bf16 values are exact in
# f32, as on the tensor cores. Every output is rounded to bf16 once.

def _bf(x):
    return x.to(torch.bfloat16).float()


def _split_matmul(x, y):
    """x @ y with x entering as two bf16 terms."""
    hi = _bf(x)
    return hi @ y + _bf(x - hi) @ y


def _mma_tiles(s, backward=False, d=64):
    """(rows a block, rows a stage) the launcher picks for S tokens: the
    forward's 128-row blocks where they pad S no more than 64-row ones; at
    head dim 128 the forward's 64-row blocks and stages of 32."""
    if s <= 32:
        return 32, 32
    if backward or d == 128:
        return 64, 32
    return (128 if (s + 63) // 64 % 2 == 0 else 64), 64


def _kept(rows, keys, causal, seq_len):
    """[rows, keys] bool: the key limit (K1/K2's padded rows) and the
    causal mask."""
    keep = (keys < seq_len)[None, :].expand(len(rows), -1)
    return keep & (keys[None, :] <= rows[:, None]) if causal else keep


def _masked_scores(qb, kb, rows, keys, causal, seq_len):
    x = qb @ kb.transpose(-1, -2) * (1.0 / qb.shape[-1] ** 0.5)
    return torch.where(_kept(rows, keys, causal, seq_len), x,
                       torch.full_like(x, tfa.MASK_VALUE))


def emulate_mma_forward(q, k, v, causal, visited=None, seq_len=None):
    """[B, H, S, D] bf16 -> bf16, as `mma_fwd_kernel` computes it, keys at
    or past `seq_len` (None: S) masked. `visited` collects the (first row,
    first key) of every (warp, stage) multiplied."""
    s = q.shape[-2]
    seq_len = s if seq_len is None else seq_len
    block, kt = _mma_tiles(s, d=q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(qf)
    for r0 in range(0, s, 16):
        rows = torch.arange(r0, min(r0 + 16, s))
        kend = min(s, r0 + 16) if causal else s
        # stages of the warp's block: with one, P is normalised, then rounded
        block_end = min(s, r0 // block * block + block) if causal else s
        one_stage = block_end <= kt
        m = torch.full(qf.shape[:2] + (len(rows), 1), -float("inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf[:, :, rows])
        for k0 in range(0, kend, kt):
            keys = torch.arange(k0, min(k0 + kt, s))
            if visited is not None:
                visited.append((r0, k0))
            x = _masked_scores(qf[:, :, rows], kf[:, :, keys], rows, keys,
                               causal, seq_len)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if one_stage:
                p = p * (1.0 / l)
            acc = acc * alpha + _bf(p) @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc if one_stage else acc * (1.0 / l)
    return out.to(torch.bfloat16)


def emulate_mma_backward(q, k, v, do, causal, seq_len=None):
    """(dq, dk, dv) in bf16, as `mma_bwd_rows_kernel` and
    `mma_bwd_keys_kernel` compute them, keys at or past `seq_len` masked."""
    s, d = q.shape[-2:]
    seq_len = s if seq_len is None else seq_len
    scale = 1.0 / d ** 0.5
    _, kt = _mma_tiles(s, backward=True)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    st_m, st_l, st_rs = (torch.empty(qf.shape[:3] + (1,)) for _ in range(3))
    for r0 in range(0, s, 16):                       # the rows kernel
        rows = torch.arange(r0, min(r0 + 16, s))
        kend = min(s, r0 + 16) if causal else s
        qb, dob = qf[:, :, rows], dof[:, :, rows]
        m = torch.full(qf.shape[:2] + (len(rows), 1), -float("inf"))
        l, r = torch.zeros_like(m), torch.zeros_like(m)
        acc_a, acc_b = torch.zeros_like(qb), torch.zeros_like(qb)
        shift = dob @ vf[:, :, :1].transpose(-1, -2)   # dP at key 0
        for k0 in range(0, kend, kt):
            keys = torch.arange(k0, min(k0 + kt, s))
            x = _masked_scores(qb, kf[:, :, keys], rows, keys, causal,
                               seq_len)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            e = torch.exp(x - m_new)
            ge = e * (dob @ vf[:, :, keys].transpose(-1, -2) - shift)
            l = l * alpha + e.sum(-1, keepdim=True)
            r = r * alpha + ge.sum(-1, keepdim=True)
            acc_a = acc_a * alpha + _split_matmul(ge, kf[:, :, keys])
            acc_b = acc_b * alpha + _split_matmul(e, kf[:, :, keys])
            m = m_new
        rs = r / l
        dq[:, :, rows] = (acc_a - rs * acc_b) * (scale / l)
        st_m[:, :, rows], st_l[:, :, rows] = m, l
        st_rs[:, :, rows] = rs + shift
    for k0 in range(0, s, 16):                       # the keys kernel
        keys = torch.arange(k0, min(k0 + 16, s))
        kb, vb = kf[:, :, keys], vf[:, :, keys]
        acc_dk, acc_dv = torch.zeros_like(kb), torch.zeros_like(kb)
        first = (k0 // kt) * kt if causal else 0
        for r0 in range(first, s, 16):
            if causal and r0 + 15 < k0:
                continue
            rows = torch.arange(r0, min(r0 + 16, s))
            qb, dob = qf[:, :, rows], dof[:, :, rows]
            x = kb @ qb.transpose(-1, -2) * scale       # [keys, rows]
            m, l, rs = (t[:, :, rows].transpose(-1, -2)
                        for t in (st_m, st_l, st_rs))
            p = torch.exp(x - m) * (1.0 / l)
            p = torch.where(_kept(rows, keys, causal, seq_len).T, p,
                            torch.zeros_like(p))
            ds = p * (vb @ dob.transpose(-1, -2) - rs) * scale
            acc_dv = acc_dv + _split_matmul(p, dob)
            acc_dk = acc_dk + _split_matmul(ds, qb)
        dk[:, :, keys], dv[:, :, keys] = acc_dk, acc_dv
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


MMA_CASES = BHSD_CASES + [
    (2, 2, 1, 16, False),     # one token
    (1, 2, 70, 32, True),     # two key stages, ragged, causal skips
]
# The bounds the card run holds the kernels to (`chip_smoke.py`): a bf16
# output may round one ulp the other way, so 2 ulps (2^-8 each) of the
# output's scale; the backward keeps f32-grade factors where autograd through
# the plain version rounds its bf16 intermediates, so 4 ulps of the largest
# gradient.
MMA_FWD_BOUND = 2 * 2.0 ** -8
MMA_BWD_BOUND = 4 * 2.0 ** -8


def _bf16_inputs(b, h, s, d, seed, n):
    return [torch.from_numpy(t).to(torch.bfloat16)
            for t in _bhsd_inputs(b, h, s, d, seed=seed, n=n)]


@pytest.mark.parametrize("b,h,s,d,causal", MMA_CASES)
def test_mma_emulation_forward_matches_plain(b, h, s, d, causal):
    q, k, v = _bf16_inputs(b, h, s, d, 12, 3)
    want = tfa.attention_bhsd_plain(q, k, v, causal).float()
    got = emulate_mma_forward(q, k, v, causal).float()
    assert (got - want).abs().max() <= MMA_FWD_BOUND * max(
        1.0, want.abs().max().item())


@pytest.mark.parametrize("b,h,s,d,causal", MMA_CASES)
def test_mma_emulation_backward_matches_plain(b, h, s, d, causal):
    q, k, v, do = _bf16_inputs(b, h, s, d, 13, 4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.attention_bhsd_plain(*leaves, causal).backward(do)
    got = emulate_mma_backward(q, k, v, do, causal)
    for g, leaf, name in zip(got, leaves, "qkv"):
        want = leaf.grad.float()
        err = (g.float() - want).abs().max().item()
        assert err <= MMA_BWD_BOUND * want.abs().max().item(), f"d{name}"


@pytest.mark.parametrize("route", ["per_head", "heads"])
@pytest.mark.parametrize("b,h,s,d,causal", MMA_CASES)
def test_mma_emulation_matches_pallas(route, b, h, s, d, causal):
    """Against K3's and K4's Pallas functions in interpret mode, bf16. The
    forward: both round P and the output to bf16, against another max, so
    2 ulps of the output's scale. The backward: both keep P and dS in f32
    and round each gradient once, so one bf16 ulp (2^-8) of the largest
    gradient, doubled for sums taken in another order."""
    q, k, v, do = _bhsd_inputs(b, h, s, d, seed=14, n=4)
    jq, jk, jv, jdo = (jnp.asarray(t).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    out, vjp = jax.vjp(lambda q, k, v: JAX_BHSD[route](q, k, v, causal),
                       jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(torch.bfloat16)
                       for t in (q, k, v, do))
    ref = np.asarray(out.astype(jnp.float32))
    got = emulate_mma_forward(tq, tk, tv, causal).float().numpy()
    assert np.abs(got - ref).max() <= MMA_FWD_BOUND * max(
        1.0, np.abs(ref).max())
    for g, w, name in zip(emulate_mma_backward(tq, tk, tv, tdo, causal),
                          want, "qkv"):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2 * 2.0 ** -8 * np.abs(w).max(), f"d{name}: {err}"


@pytest.mark.parametrize("b,h,s,d,causal", [(2, 3, 32, 64, True),
                                            (2, 2, 21, 64, True),
                                            (2, 2, 64, 16, False)])
def test_mma_emulation_one_stage_rounds_p_as_plain(b, h, s, d, causal):
    """A head that fits one stage has m and l before P.V, so P is normalised
    and then rounded, as the plain version rounds it: the two differ only
    where 1 / l times exp and exp over l round apart, so nearly every output
    is the same bf16 value and none is further than one bf16 ulp (2^-8 of
    the output's scale), half the forward's bound."""
    q, k, v = _bf16_inputs(b, h, s, d, 19, 3)
    want = tfa.attention_bhsd_plain(q, k, v, causal)
    got = emulate_mma_forward(q, k, v, causal)
    assert (got == want).float().mean() > 0.99
    assert (got.float() - want.float()).abs().max() <= 2.0 ** -8 * max(
        1.0, want.float().abs().max().item())


def test_mma_emulation_one_key_row_has_zero_dq():
    """softmax over one key is constant: dQ and dK are exactly 0, which the
    shift of dP by its value at key 0 keeps."""
    q, k, v, do = _bf16_inputs(2, 2, 1, 16, 15, 4)
    dq, dk, dv = emulate_mma_backward(q, k, v, do, False)
    assert not dq.any() and not dk.any()
    assert torch.equal(dv, do)


def test_mma_emulation_skips_masked_stages():
    """With the causal mask a warp visits only the stages up to its last
    row; without it, every stage."""
    q, k, v = _bf16_inputs(1, 1, 150, 16, 16, 3)
    causal, full = [], []
    emulate_mma_forward(q, k, v, True, visited=causal)
    emulate_mma_forward(q, k, v, False, visited=full)
    assert len(full) == 10 * 3            # 10 warps of 16 rows, 3 stages
    assert causal == [(r0, k0) for r0 in range(0, 150, 16)
                      for k0 in range(0, min(150, r0 + 16), 64)]
    assert len(causal) < len(full)


def test_mma_emulation_moves_the_running_max():
    """A score of about 80 in the second stage: everything summed before
    it is rescaled by exp(m_old - m_new), and the result still agrees."""
    q, k, v, do = _bf16_inputs(1, 2, 100, 16, 17, 4)
    k[:, :, 90] = 20.0 * q[:, :, 5]
    scores = q.float() @ k.float().transpose(-1, -2) / 4.0
    assert scores[:, :, 5, 90].min() > 40 and scores[:, :, 5, :64].max() < 20
    want = tfa.attention_bhsd_plain(q, k, v, False).float()
    got = emulate_mma_forward(q, k, v, False).float()
    assert (got - want).abs().max() <= MMA_FWD_BOUND * max(
        1.0, want.abs().max().item())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.attention_bhsd_plain(*leaves, False).backward(do)
    for g, leaf in zip(emulate_mma_backward(q, k, v, do, False), leaves):
        want = leaf.grad.float()
        assert (g.float() - want).abs().max() <= MMA_BWD_BOUND * \
            want.abs().max()


def test_bhsd_wrappers_need_16_byte_alignment():
    """The kernels copy 16 bytes a request: a tensor that starts off a
    16-byte boundary, or is not contiguous, is refused."""
    base = torch.zeros(2 * 2 * 16 * 16 + 8, dtype=torch.bfloat16)
    tfa._check_bhsd_layout(base[:-8].view(2, 2, 16, 16))
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_bhsd_layout(base[1:-7].view(2, 2, 16, 16))
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_bhsd_layout(
            base[:-8].view(2, 2, 16, 16).transpose(1, 2))


# the odd geometries of the tensor-core route (need the card)

BHSD_ODD_CASES = [
    # (B, H, S, D, causal), all bf16
    (3, 4, 1, 64, False),
    (3, 4, 21, 64, True),
    (2, 4, 37, 64, False),
    (1, 16, 577, 64, False),
    (2, 4, 70, 16, True),
    (2, 4, 70, 32, False),
    (2, 4, 129, 64, True),    # a last tile of one row
]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["per_head", "heads"])
@pytest.mark.parametrize("b,h,s,d,causal", BHSD_ODD_CASES)
def test_bhsd_tensor_core_route_odd_geometries(cuda_device, route, b, h, s, d,
                                               causal):
    """K3/K4 on the tensor cores against the plain version within the card
    run's bounds, with a large score late in a row where the head is long
    enough; the backward twice, bit for bit."""
    assert tfa.bhsd_kernel_route(torch.bfloat16, d) == "tensor cores"
    q, k, v, do = _bf16_inputs(b, h, s, d, 18, 4)
    if s > 80:
        k[:, :, s - 77] = 10.0 * q[:, :, 5]
    q, k, v, do = (t.to(cuda_device) for t in (q, k, v, do))
    out = getattr(tfa, f"{route}_forward_cuda")(q, k, v, causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tfa.attention_bhsd_plain(*leaves, causal)
    ref.backward(do)
    backward = getattr(tfa, f"{route}_backward_cuda")
    grads, again = backward(q, k, v, do, causal), backward(q, k, v, do, causal)
    torch.cuda.synchronize()
    ref = ref.detach().float()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max() <= MMA_FWD_BOUND * max(
        1.0, ref.abs().max().item())
    for got, got2, leaf in zip(grads, again, leaves):
        want = leaf.grad.float()
        assert torch.isfinite(got).all() and torch.equal(got, got2)
        assert (got.float() - want).abs().max() <= MMA_BWD_BOUND * \
            want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 16, "tensor cores"), (torch.bfloat16, 32, "tensor cores"),
    (torch.bfloat16, 64, "tensor cores"), (torch.float32, 64, "key-tiled FMA"),
    (torch.float32, 16, "key-tiled FMA")])
def test_bhsd_kernel_route_per_input(cuda_device, dtype, d, route):
    """bf16 heads go to the tensor-core bodies, f32 heads to the FMA ones."""
    assert tfa.bhsd_kernel_route(dtype, d) == route
    with pytest.raises(ValueError, match="no bhsd attention kernel"):
        tfa.bhsd_kernel_route(dtype, 48)


# ------------- K1/K2's bf16 route: the same bodies over [B, S, H*D] rows
#
# K1 and K2 take the bodies emulated above, a head addressed by its column
# slice of every row, with the keys at or past seq_len masked. At the
# towers' geometries (S = 64 with 50 true tokens: one stage, P normalised
# before it is rounded; 208 with 197: four stages, P rounded against the
# running max) the emulation is held to the bounds of the card run against
# the plain version and against K1/K2's Pallas functions in interpret mode.

BSHD_MMA_CASES = [
    # (B, S, heads, head_dim, seq_len)
    (2, 64, 2, 16, 50),      # ViT-B/32: 50 tokens padded to 64
    (1, 208, 2, 16, 197),    # ViT-B/16: 197 padded to 208
    (2, 48, 3, 32, 30),      # a ragged tile
    (1, 112, 2, 64, 70),     # two stages, the second mostly padding
]
# head dim 128 (AIMv2's) through the same walk, its forward in 64-row blocks
# and stages of 32 keys
BSHD_MMA_D128_CASES = [
    (2, 256, 2, 128, 256),   # AIMv2-L/14's 256 tokens
    (1, 112, 2, 128, 70),
]


def emulate_bshd_forward(q, k, v, heads, seq_len):
    qh, kh, vh = (tfa._split_heads(t, heads) for t in (q, k, v))
    return tfa._merge_heads(emulate_mma_forward(qh, kh, vh, False,
                                                seq_len=seq_len))


def emulate_bshd_backward(q, k, v, do, heads, seq_len):
    grads = emulate_mma_backward(
        *(tfa._split_heads(t, heads) for t in (q, k, v, do)), False,
        seq_len=seq_len)
    return tuple(tfa._merge_heads(g) for g in grads)


def _bshd_bf16(b, s, h, d, seed, n):
    return [torch.from_numpy(t).to(torch.bfloat16)
            for t in _inputs(b, s, h, d, seed=seed, n=n)]


@pytest.mark.parametrize("b,s,h,d,seq_len",
                         BSHD_MMA_CASES + BSHD_MMA_D128_CASES)
def test_mma_emulation_bshd_matches_plain(b, s, h, d, seq_len):
    """The rows the towers read (below seq_len) within the card run's
    bounds; dK and dV of padded keys exactly 0, as the plain version's."""
    q, k, v, do = _bshd_bf16(b, s, h, d, 23, 4)
    want = tfa.attention_bshd_plain(q, k, v, h, seq_len).float()
    got = emulate_bshd_forward(q, k, v, h, seq_len).float()
    assert (got - want)[:, :seq_len].abs().max() <= MMA_FWD_BOUND * max(
        1.0, want.abs().max().item())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.attention_bshd_plain(*leaves, h, seq_len).backward(do)
    for g, leaf, name in zip(emulate_bshd_backward(q, k, v, do, h, seq_len),
                             leaves, "qkv"):
        want = leaf.grad.float()
        err = (g.float() - want)[:, :seq_len].abs().max().item()
        assert err <= MMA_BWD_BOUND * want.abs().max().item(), f"d{name}"
        if name in "kv":
            assert not g[:, seq_len:].any() and not want[:, seq_len:].any()


@pytest.mark.parametrize("b,s,h,d,seq_len", BSHD_MMA_CASES)
def test_mma_emulation_bshd_matches_pallas(b, s, h, d, seq_len):
    """Against `attention_bshd_fused` (K1/K2's Pallas kernels, interpret
    mode) in bf16, on the rows below seq_len, with the bounds of
    `test_mma_emulation_matches_pallas`."""
    q, k, v, do = _inputs(b, s, h, d, seed=24, n=4)
    jq, jk, jv, jdo = (jnp.asarray(t).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    out, vjp = jax.vjp(lambda q, k, v: _jax_attention(q, k, v, h, seq_len),
                       jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(torch.bfloat16)
                       for t in (q, k, v, do))
    ref = np.asarray(out.astype(jnp.float32))[:, :seq_len]
    got = emulate_bshd_forward(tq, tk, tv, h, seq_len).float().numpy()
    assert np.abs(got[:, :seq_len] - ref).max() <= MMA_FWD_BOUND * max(
        1.0, np.abs(ref).max())
    for g, w, name in zip(emulate_bshd_backward(tq, tk, tv, tdo, h, seq_len),
                          want, "qkv"):
        w = np.asarray(w.astype(jnp.float32))[:, :seq_len]
        err = np.abs(g.float().numpy()[:, :seq_len] - w).max()
        assert err <= 2 * 2.0 ** -8 * np.abs(w).max(), f"d{name}: {err}"


def test_mma_emulation_bshd_one_stage_rounds_p_as_plain():
    """ViT-B/32's head (64 keys, 50 true) fits one stage: P is normalised
    and then rounded, as the plain version does, so nearly every output is
    the same bf16 value."""
    q, k, v = _bshd_bf16(4, 64, 2, 16, 25, 3)
    want = tfa.attention_bshd_plain(q, k, v, 2, 50)[:, :50]
    got = emulate_bshd_forward(q, k, v, 2, 50)[:, :50]
    assert (got == want).float().mean() > 0.99


BSHD_ODD_CASES = [
    # (B, S, heads, head_dim, seq_len), all bf16
    (4, 64, 12, 64, 50),      # ViT-B/32
    (2, 208, 4, 16, 197),     # head dim 16 at ViT-B/16's length
    (2, 100, 3, 32, 70),      # head dim 32, ragged
    (3, 32, 4, 64, 17),       # a short head: 2 warps, 32-row stages
    (3, 16, 2, 16, 1),        # one true key
    (1, 592, 16, 64, 577),    # ViT-L/14@336px, a large score late in a row
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,seq_len", BSHD_ODD_CASES)
def test_bshd_tensor_core_route_odd_geometries(cuda_device, b, s, h, d,
                                               seq_len):
    """K1/K2 on the tensor cores against the plain version within the card
    run's bounds, on the rows below seq_len; the backward twice, bit for
    bit."""
    assert tfa.kernel_route(False, torch.bfloat16, s, d) == "tensor cores"
    assert tfa.kernel_route(True, torch.bfloat16, s, d) == "tensor cores"
    q, k, v, do = _bshd_bf16(b, s, h, d, 26, 4)
    if s > 500:
        k[:, s - 77] = 10.0 * q[:, 5]
    q, k, v, do = (t.to(cuda_device) for t in (q, k, v, do))
    out = tfa.bshd_forward_cuda(q, k, v, h, seq_len)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tfa.attention_bshd_plain(*leaves, h, seq_len)
    ref.backward(do)
    grads = tfa.bshd_backward_cuda(q, k, v, do, h, seq_len)
    again = tfa.bshd_backward_cuda(q, k, v, do, h, seq_len)
    torch.cuda.synchronize()
    ref = ref.detach().float()
    assert torch.isfinite(out[:, :seq_len]).all()
    assert (out.float() - ref)[:, :seq_len].abs().max() <= MMA_FWD_BOUND * \
        max(1.0, ref.abs().max().item())
    for got, got2, leaf in zip(grads, again, leaves):
        want = leaf.grad.float()
        assert torch.isfinite(got).all() and torch.equal(got, got2)
        assert (got.float() - want)[:, :seq_len].abs().max() <= \
            MMA_BWD_BOUND * want.abs().max()


# the forward's tile heights on either side of the rule: 128-row blocks at
# an even number of 64-row tiles (65, 128, 197, 256), 64-row ones otherwise
# (64, 129, 192, 257)
WIDE_RULE_CASES = [64, 65, 128, 129, 192, 197, 256, 257]


@pytest.mark.cuda
@pytest.mark.parametrize("s", WIDE_RULE_CASES)
def test_forward_tile_rule_geometries(cuda_device, s):
    """K1 (rows of [B, S, H*D], the last 5 keys padding), K3 and K4 (causal)
    at lengths on either side of the 8-warp rule, against the plain
    versions within the card run's forward bound."""
    q, k, v = (t.to(cuda_device) for t in _bshd_bf16(2, s, 4, 64, 27, 3))
    out = tfa.bshd_forward_cuda(q, k, v, 4, s - 5)
    ref = tfa.attention_bshd_plain(q, k, v, 4, s - 5).float()
    torch.cuda.synchronize()
    assert (out.float() - ref)[:, :s - 5].abs().max() <= MMA_FWD_BOUND * \
        max(1.0, ref.abs().max().item())
    qh, kh, vh = (t.to(cuda_device) for t in _bf16_inputs(2, 4, s, 64, 28, 3))
    ref = tfa.attention_bhsd_plain(qh, kh, vh, True).float()
    for forward in (tfa.per_head_forward_cuda, tfa.heads_forward_cuda):
        out = forward(qh, kh, vh, True)
        torch.cuda.synchronize()
        assert (out.float() - ref).abs().max() <= MMA_FWD_BOUND * max(
            1.0, ref.abs().max().item())


def test_emulated_forward_tile_rule():
    """The launcher's rule as the emulation reads it."""
    assert [_mma_tiles(s)[0] for s in WIDE_RULE_CASES] == \
        [64, 128, 128, 64, 64, 128, 128, 64]
    assert _mma_tiles(32) == (32, 32) and _mma_tiles(197, True) == (64, 32)
