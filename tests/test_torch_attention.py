"""bshd attention of the PyTorch port against the JAX package's Pallas kernel.

`attention_bshd_plain` (the CPU path and the oracle of the CUDA kernels) is
held against `ttl_tpu.ops.attention.attention_bshd_fused`, which runs the
Pallas kernels in interpret mode on the CPU. Inputs are made with numpy.
Tolerances: forward rtol/atol 2e-5 and VJP rtol 2e-4 / atol 2e-5 at f32,
the bounds of the JAX package's own kernel tests (f32 sums in another
order). The CUDA kernel cases run only where a card is present; they cover
every route, the key-tiled one at ViT-L/14@336px's 592 tokens included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    # ViT-L/14's 272 tokens; past 288 keys the bf16 forward takes the
    # key-tiled kernel
    (2, 272, 4, 64, 257, torch.bfloat16, 1e-2, 2e-2),
    (2, 304, 4, 64, 290, torch.bfloat16, 1e-2, 2e-2),
    # the key-tiled route: ViT-L/14@336px (577 tokens padded to 592) in both
    # dtypes, ViT-L/14 (257 padded to 272) in the f32 backward
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
    (False, torch.float32, 208, "key-tiled FMA"),     # every FMA forward
    (True, torch.float32, 208, "whole-head FMA"),
    (True, torch.bfloat16, 272, "whole-head FMA"),    # ViT-L/14
    (True, torch.float32, 272, "key-tiled FMA"),
    (False, torch.bfloat16, 592, "key-tiled FMA"),    # ViT-L/14@336px
    (True, torch.float32, 592, "key-tiled FMA"),
])
def test_kernel_route_per_geometry(cuda_device, backward, dtype, s, route):
    """Tensor cores where they fit; then the key-tiled forward, and the
    whole-head backward where it fits shared memory."""
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
