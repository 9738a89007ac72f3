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
