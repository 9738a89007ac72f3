"""The layernorm of the port (`ops/layer_norm.py`, `csrc/layer_norm.cu`) and
the dispatch of `models.clip.layer_norm`.

- The plain version is the body `models.clip.layer_norm` ran before the
  kernels existed, bit for bit, in bf16 and f32 under both TTL_LN_STATS
  modes; `models.clip.layer_norm` gives those bits on the CPU.
- The dispatch: every CPU call takes the plain version (no launch
  counted), whatever its statistics, width, dtype or trained scale; on the
  card every call goes through `ops.layer_norm.layer_norm`, which raises
  where the kernels do not fit.
- `layer_norm.launches` counts one a forward and one a backward; the plain
  backward against autograd through the plain version.
- The launches of one TTL step at ViT-B/16's, ViT-L/14's and EVA02-L/14's
  depths, with the CPU's plain calls sent through the op to count them, and
  that step's logits against the plain version's.
- A logical width below the row length (EVA02's LN_ffn over 2730 of 2736
  stored columns on the card): the plain forward is the old body on the
  first n columns bit for bit and 0 past them, the plain dx the plain dx of
  those columns and 0 past them, whatever the padding holds; n equal to the
  row is the call without it; `layer_norm.strided_launches` counts only
  the calls below the row, 36 a padded EVA02 step and none on CLIP's.
- On the card (`cuda`-marked): the kernels against the plain version at the
  towers' widths (512, 768, 1024, 2730) and row counts that fill no whole
  block, dx against autograd through the plain version, strided inputs,
  TTL_LN_STATS=ex2, and the calls the kernels refuse; the masked kernels
  at [rows, 2736] with n = 2730 and on the warp route with an odd n, and
  n equal to the row giving the unmasked kernels' bits.
"""
import pytest
import torch
import torch.nn.functional as F

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import eva02 as teva
from ttl_tpu_torch.models.zoo import EVA02_TINY, TEST_TINY
from ttl_tpu_torch.ops import layer_norm as tln
from ttl_tpu_torch.runner import make_adapters0

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def old_layer_norm(x, p, eps, stats):
    """`models.clip.layer_norm` as the port ran it before the kernels."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    if stats == "ex2":
        var = (x32.square().mean(dim=-1, keepdim=True)
               - mu.square()).clamp(min=0.0)
    else:
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def inputs(rows, k, dtype, device="cpu", seed=0):
    """x with an offset and a spread per row, scale and bias off 1 and 0
    (f32, as the port keeps them), dy."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, k, generator=g) * (0.5 + torch.rand(
        rows, 1, generator=g) * 3) + torch.randn(rows, 1, generator=g))
    p = {"scale": 1 + 0.3 * torch.randn(k, generator=g),
         "bias": 0.3 * torch.randn(k, generator=g)}
    dy = torch.randn(rows, k, generator=g)
    return (x.to(device, dtype), {n: t.to(device) for n, t in p.items()},
            dy.to(device, dtype))


# ------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("stats", ["centered", "ex2"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_plain_version_is_the_old_layer_norm_bit_for_bit(dtype, stats,
                                                         monkeypatch):
    monkeypatch.setenv("TTL_LN_STATS", stats)
    x, p, _ = inputs(37, 96, dtype)
    x = x.reshape(37, 3, 32)
    p = {n: t[:32] for n, t in p.items()}
    want = old_layer_norm(x, p, 1e-5, stats)
    before = tln.layer_norm.launches
    for got in (tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-5, stats),
                tclip.layer_norm(x, p, 1e-5)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert tln.layer_norm.launches == before


def test_gradients_through_the_cpu_dispatch_are_autograds_of_the_old_body():
    x, p, dy = inputs(9, 64, torch.float32)
    x.requires_grad_(True)
    (want,) = torch.autograd.grad(old_layer_norm(x, p, 1e-6, "centered"),
                                  x, dy)
    (got,) = torch.autograd.grad(tclip.layer_norm(x, p, 1e-6), x, dy)
    assert torch.equal(got, want)


def test_dispatch(monkeypatch):
    """On the CPU a centered call, ex2, a trained scale or bias, an odd
    width, a width past MAX_K and f16 all take the plain version,
    uncounted."""
    x, p, _ = inputs(6, 64, torch.bfloat16)

    def launches(x, p):
        before = tln.layer_norm.launches
        out = tclip.layer_norm(x, p, 1e-5)
        assert torch.equal(out, old_layer_norm(x, p, 1e-5,
                                               tclip.ln_stats_mode()))
        return tln.layer_norm.launches - before

    assert launches(x, p) == 0
    trained = {**p, "scale": p["scale"].clone().requires_grad_(True)}
    assert launches(x, trained) == 0
    assert launches(x, {**p, "bias": p["bias"].clone().requires_grad_(True)}) \
        == 0
    odd, po, _ = inputs(6, 85, torch.bfloat16)
    wide, pw, _ = inputs(2, tln.MAX_K + 2, torch.bfloat16)
    assert launches(odd, po) == launches(wide, pw) == 0
    assert launches(x.half(), p) == 0
    monkeypatch.setenv("TTL_LN_STATS", "ex2")
    assert launches(x, p) == 0


def test_trained_scale_raises_in_the_op():
    x, p, _ = inputs(4, 32, torch.float32)
    with pytest.raises(ValueError, match="no gradient for its scale"):
        tln.layer_norm(x, p["scale"].requires_grad_(True), p["bias"], 1e-5)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_launches_and_the_plain_backward_against_autograd(dtype):
    """bf16: both sides compute dx in f32 and round it once, so an output
    differs by at most one bf16 step (2^-7 of it), plus 2^-16 of the
    largest where the three terms of dx cancel; f32: the order of the sums,
    1e-5 of the largest."""
    rel, floor = (2.0 ** -7, 2.0 ** -16) if dtype == torch.bfloat16 \
        else (0.0, 1e-5)
    x, p, dy = inputs(11, 96, dtype, seed=3)
    leaf = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        tln.layer_norm_plain(leaf, p["scale"], p["bias"], 1e-5), leaf, dy)
    before = tln.layer_norm.launches
    y = tln.layer_norm(leaf, p["scale"], p["bias"], 1e-5)
    (got,) = torch.autograd.grad(y, leaf, dy)
    assert tln.layer_norm.launches - before == 2        # forward, backward
    assert torch.equal(y, tln.layer_norm_plain(x, p["scale"], p["bias"],
                                               1e-5))
    assert got.dtype == dtype
    got, want = got.float(), want.float()
    assert ((got - want).abs() <= rel * want.abs()
            + floor * want.abs().max()).all()
    before = tln.layer_norm.launches
    with torch.no_grad():
        tln.layer_norm(leaf, p["scale"], p["bias"], 1e-5)
    tln.layer_norm(x, p["scale"], p["bias"], 1e-5)
    assert tln.layer_norm.launches - before == 2        # two forwards


# -------------------------------------------------------- logical width

@pytest.mark.parametrize("n", [85, 86])
@pytest.mark.parametrize("stats", ["centered", "ex2"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_logical_width_forward_is_the_old_body_on_its_columns(dtype, stats,
                                                              n):
    """The padding holds values (a card layout keeps zeros there; the
    function must not read them either way)."""
    x, p, _ = inputs(13, 88, dtype, seed=n)
    got = tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-6, stats, n)
    want = old_layer_norm(x[:, :n], {k: t[:n] for k, t in p.items()}, 1e-6,
                          stats)
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got[:, :n], want) and not got[:, n:].any()
    assert torch.equal(
        tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-6, stats, 88),
        tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-6, stats))


@pytest.mark.parametrize("n", [85, 86])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_logical_width_backward_is_the_plain_dx_of_its_columns(dtype, n):
    """dx of the logical columns as `layer_norm_grad_plain` gives it for
    those columns alone (the statistics of those columns), 0 past them;
    through the op on the CPU a forward and a backward, each counted as a
    launch and a strided launch; autograd through the old body on the
    columns within the bound of the full-width test."""
    rel, floor = (2.0 ** -7, 2.0 ** -16) if dtype == torch.bfloat16 \
        else (0.0, 1e-5)
    x, p, dy = inputs(11, 88, dtype, seed=n + 1)
    x32 = x[:, :n].float()
    mu = x32.mean(-1)
    rstd = torch.rsqrt(x32.var(-1, unbiased=False) + 1e-6)
    got = tln.layer_norm_grad_plain(x, dy, p["scale"], mu, rstd, n)
    want = tln.layer_norm_grad_plain(x[:, :n], dy[:, :n], p["scale"][:n],
                                     mu, rstd)
    assert torch.equal(got[:, :n], want) and not got[:, n:].any()
    leaf = x.clone().requires_grad_(True)
    before = tln.layer_norm.launches, tln.layer_norm.strided_launches
    y = tln.layer_norm(leaf, p["scale"], p["bias"], 1e-6, width=n)
    (dx,) = torch.autograd.grad(y, leaf, dy)
    assert (tln.layer_norm.launches - before[0],
            tln.layer_norm.strided_launches - before[1]) == (2, 2)
    assert torch.equal(y, tln.layer_norm_plain(x, p["scale"], p["bias"],
                                               1e-6, width=n))
    assert not dx[:, n:].any()
    part = x[:, :n].clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        old_layer_norm(part, {k: t[:n] for k, t in p.items()}, 1e-6,
                       "centered"), part, dy[:, :n])
    d, ref = dx[:, :n].float(), ref.float()
    assert ((d - ref).abs() <= rel * ref.abs()
            + floor * ref.abs().max()).all()


def test_full_logical_width_is_the_call_without_it():
    x, p, dy = inputs(9, 64, torch.bfloat16)
    leaf = x.clone().requires_grad_(True)
    before = tln.layer_norm.launches, tln.layer_norm.strided_launches
    outs = []
    for width in (None, 64):
        y = tln.layer_norm(leaf, p["scale"], p["bias"], 1e-6, width=width)
        outs.append((y, *torch.autograd.grad(y, leaf, dy)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert (tln.layer_norm.launches - before[0],
            tln.layer_norm.strided_launches - before[1]) == (4, 0)


@pytest.mark.parametrize("width", [0, 65])
def test_logical_width_outside_the_row_raises(width):
    x, p, _ = inputs(3, 64, torch.float32)
    with pytest.raises(ValueError, match="logical width"):
        tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-6, width=width)
    with pytest.raises(ValueError, match="logical width"):
        tln.layer_norm(x, p["scale"], p["bias"], 1e-6, width=width)


def _step(clip_cfg, dtype, layout=None):
    cfg = TTLConfig(arch="test-tiny", seed=3, resolution=64, sample_batch=2,
                    batch_size=4, compute_dtype=dtype, param_dtype=dtype)
    params = tclip.init_clip_params(clip_cfg, torch.Generator().manual_seed(
        3), device="cpu", param_dtype=getattr(torch, dtype))
    if layout is not None:
        params = {**params, "vision": layout(params["vision"],
                                             clip_cfg.vision)}
    adapters0 = make_adapters0(cfg, clip_cfg, "cpu")
    g = torch.Generator().manual_seed(4)
    classes = F.normalize(torch.randn(5, 16, generator=g), dim=-1)
    images = torch.randn(2, 4, 3, 64, 64, generator=g)
    return make_batched_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)(
        params, classes, adapters0, images)


@pytest.mark.parametrize("arch,layers,launches", [
    ("clip", 12, 28), ("clip", 24, 28), ("eva02", 24, 105)],
    ids=["vitb16-depth", "vitl14-depth", "eva02l14-depth"])
def test_launches_of_a_step(arch, layers, launches, monkeypatch):
    """One step (window = the last 3 layers, zero-shot pass on), with the
    CPU's plain calls sent through the op, as the card's are. CLIP: ln_pre
    (the prefix folds into K6), the window's 2 a layer and ln_post forward,
    their backward but the first layer's ln1 (its input takes no gradient),
    the clean and zero-shot passes' 7 each: 8 x 3 + 4. EVA02: LN2 and LN_ffn in each prefix layer,
    the window's 4 a layer and LN_post forward, again in the backward's
    recompute, backward but the first LN1, the two clean passes:
    2 x 21 + 20 x 3 + 3. The logits are the plain version's within 1e-4
    (f32; only the backward's sums differ)."""
    if arch == "clip":
        vision = tclip.VisionConfig(hidden=32, layers=layers, heads=2,
                                    proj_dim=16, patch=16, image_size=64)
        text = TEST_TINY.text
    else:                   # an even SwiGLU width, which the kernels fit
        vision = teva.EVA02VisionConfig(
            hidden=32, layers=layers, heads=2, proj_dim=16, patch=16,
            image_size=64, mlp_hidden=86, rope_pretrain_grid=2)
        text = EVA02_TINY.text
    clip_cfg = tclip.CLIPConfig(vision=vision, text=text)
    plain = _step(clip_cfg, "float32")
    monkeypatch.setattr(tln, "layer_norm_plain",
                        lambda x, scale, bias, eps, stats="centered",
                        width=None:
                        tln.layer_norm(x, scale, bias, eps, stats, width))
    before = tln.layer_norm.launches
    res = _step(clip_cfg, "float32")
    assert tln.layer_norm.launches - before == launches
    for got, want in ((res.logits, plain.logits),
                      (res.zero_shot_logits, plain.zero_shot_logits)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    before = tln.layer_norm.launches
    _step(clip_cfg, "bfloat16")
    assert tln.layer_norm.launches - before == launches


@pytest.mark.parametrize("arch,layers,padded,strided", [
    ("clip", 12, False, 0), ("clip", 24, False, 0),
    ("eva02", 24, False, 0), ("eva02", 24, True, 36)],
    ids=["vitb16-depth", "vitl14-depth", "eva02l14-depth",
         "eva02l14-depth-card-layout"])
def test_strided_launches_of_a_step(arch, layers, padded, strided,
                                    monkeypatch):
    """`layer_norm.strided_launches` over one step, the CPU's plain calls
    sent through the op: LN_ffn's forwards and backwards where the MLP is
    stored padded (`card_layout`, 85 -> 88 here, as 2730 -> 2736 on the
    card), as many as SwiGLU's 36 at depth 24 (21 prefix layers, the
    window's 3 forward, again in the recompute and backward, the two clean
    passes' 6); none on CLIP or an unpadded EVA02; the padded step's logits
    those of the unpadded one within f32 rounding."""
    if arch == "clip":
        vision = tclip.VisionConfig(hidden=32, layers=layers, heads=2,
                                    proj_dim=16, patch=16, image_size=64)
        text = TEST_TINY.text
    else:
        vision = teva.EVA02VisionConfig(
            hidden=32, layers=layers, heads=2, proj_dim=16, patch=16,
            image_size=64, mlp_hidden=85, rope_pretrain_grid=2)
        text = EVA02_TINY.text
    clip_cfg = tclip.CLIPConfig(vision=vision, text=text)
    layout = teva.card_layout if padded else None
    monkeypatch.setattr(tln, "layer_norm_plain",
                        lambda x, scale, bias, eps, stats="centered",
                        width=None:
                        tln.layer_norm(x, scale, bias, eps, stats, width))
    before = tln.layer_norm.strided_launches
    res = _step(clip_cfg, "float32", layout)
    assert tln.layer_norm.strided_launches - before == strided
    if padded:
        plain = _step(clip_cfg, "float32")
        for got, want in ((res.logits, plain.logits),
                          (res.zero_shot_logits, plain.zero_shot_logits)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layernorm kernels run only "
                    "there")
    return torch.device("cuda")


# bf16: both sides round the same f32 value once; the statistics sum in
# another order, so an output may round one bf16 step (2^-7 of it) the other
# way, plus 2^-16 of the largest where the affine's add cancels, in under
# 1 % of the outputs. f32: the order of the sums, 1e-5 of the largest.
FWD_BOUND = {torch.bfloat16: (2.0 ** -7, 2.0 ** -16, 0.01),
             torch.float32: (0.0, 1e-5, 1.0)}


def _within(got, want, rel, floor, share=1.0):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (err <= rel * want.abs() + floor * want.abs().max()).all(), \
        err.max().item()
    assert (err > 0).float().mean().item() <= share


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype", [
    (1001, 512, torch.bfloat16), (8 * 208 + 1, 768, torch.bfloat16),
    (4 * 592 + 3, 1024, torch.bfloat16), (2 * 592 + 1, 2730, torch.bfloat16),
    (257, 4096, torch.bfloat16), (99, 64, torch.bfloat16),
    (513, 1024, torch.float32), (131, 2730, torch.float32)],
    ids=["512", "768", "1024", "2730", "4096", "64", "f32-1024",
         "f32-2730"])
def test_forward_against_the_plain_version(card, rows, k, dtype):
    x, p, _ = inputs(rows, k, dtype, card, seed=k)
    want = tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-6)
    before = tln.layer_norm.launches
    got = tclip.layer_norm(x, p, 1e-6)
    assert tln.layer_norm.launches - before == 1
    assert got.dtype == dtype and got.shape == x.shape
    _within(got, want, *FWD_BOUND[dtype])
    y, mu, rstd = tln.layer_norm_cuda(x, p["scale"], p["bias"], 1e-6,
                                      with_stats=True)
    assert torch.equal(y, got)
    x32 = x.float()
    torch.testing.assert_close(mu, x32.mean(-1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        rstd, torch.rsqrt(x32.var(-1, unbiased=False) + 1e-6), rtol=1e-5,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype", [
    (8 * 208 + 1, 768, torch.bfloat16), (4 * 592 + 3, 1024, torch.bfloat16),
    (2 * 592 + 1, 2730, torch.bfloat16), (513, 2730, torch.float32)],
    ids=["768", "1024", "2730", "f32-2730"])
def test_backward_against_autograd_through_the_plain_version(card, rows, k,
                                                             dtype):
    """dx within one bf16 step of autograd's (both round an f32 value once)
    plus 2^-12 of the largest, where g - mean(g) - xh mean(g xh) cancels and
    the two sum in another order; f32 1e-5 of the largest."""
    rel, floor = (2.0 ** -7, 2.0 ** -12) if dtype == torch.bfloat16 \
        else (0.0, 1e-5)
    x, p, dy = inputs(rows, k, dtype, card, seed=k + 1)
    leaf = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        tln.layer_norm_plain(leaf, p["scale"], p["bias"], 1e-6), leaf, dy)
    before = tln.layer_norm.launches
    (got,) = torch.autograd.grad(tclip.layer_norm(leaf, p, 1e-6), leaf, dy)
    assert tln.layer_norm.launches - before == 2
    _within(got, want, rel, floor)
    (again,) = torch.autograd.grad(tclip.layer_norm(leaf, p, 1e-6), leaf, dy)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_strided_and_misaligned_inputs(card):
    """ln_post's class-token rows x[:, 0], a column slice and rows that
    start off a pair boundary: copied first, forward and backward as on a
    contiguous copy."""
    h, p, _ = inputs(16 * 208, 768, torch.bfloat16, card, seed=5)
    flat = h.flatten()
    h = h.reshape(16, 208, 768)
    for x in (h[:, 0], h.reshape(-1, 1536)[:, 768:],
              flat[1:1 + 64 * 768].view(64, 768)):
        assert not x.is_contiguous() or x.data_ptr() % 4
        leaf = x.detach().requires_grad_(True)
        y = tclip.layer_norm(leaf, p, 1e-5)
        dy = torch.randn_like(y)
        (dx,) = torch.autograd.grad(y, leaf, dy)
        c = x.detach().clone().requires_grad_(True)
        yc = tclip.layer_norm(c, p, 1e-5)
        (dxc,) = torch.autograd.grad(yc, c, dy)
        assert torch.equal(y, yc) and torch.equal(dx, dxc)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype", [
    (4 * 592 + 3, 1024, torch.bfloat16), (2 * 592 + 1, 2730, torch.bfloat16),
    (131, 2730, torch.float32)], ids=["1024", "2730", "f32-2730"])
def test_ex2_statistics_on_the_card(card, rows, k, dtype, monkeypatch):
    """TTL_LN_STATS=ex2 runs the kernels too: the forward against the plain
    version's ex2 within FWD_BOUND (the variance E[x^2] - mu^2 sums in
    another order), dx against autograd through it as the centered
    backward's."""
    monkeypatch.setenv("TTL_LN_STATS", "ex2")
    x, p, dy = inputs(rows, k, dtype, card, seed=k + 2)
    leaf = x.clone().requires_grad_(True)
    want = tln.layer_norm_plain(leaf, p["scale"], p["bias"], 1e-6, "ex2")
    (want_dx,) = torch.autograd.grad(want, leaf, dy)
    before = tln.layer_norm.launches
    got = tclip.layer_norm(leaf, p, 1e-6)
    (got_dx,) = torch.autograd.grad(got, leaf, dy)
    assert tln.layer_norm.launches - before == 2
    _within(got, want, *FWD_BOUND[dtype])
    _within(got_dx, want_dx, *((2.0 ** -7, 2.0 ** -12)
                               if dtype == torch.bfloat16 else (0.0, 1e-5)))


@pytest.mark.cuda
def test_calls_the_kernels_do_not_take_raise_on_the_card(card):
    """An odd width, one past MAX_K, f16 and a scale or bias that takes a
    gradient raise on the card, counting no launch; none falls back to the
    plain version."""
    x, p, _ = inputs(6, 64, torch.bfloat16, card)
    odd, po, _ = inputs(6, 85, torch.bfloat16, card)
    wide, pw, _ = inputs(2, tln.MAX_K + 2, torch.bfloat16, card)
    before = tln.layer_norm.launches
    for bad, params in ((odd, po), (wide, pw), (x.half(), p)):
        with pytest.raises(ValueError, match="layer_norm kernels take"):
            tclip.layer_norm(bad, params, 1e-5)
    for name in ("scale", "bias"):
        trained = {**p, name: p[name].clone().requires_grad_(True)}
        with pytest.raises(ValueError, match="no gradient for its scale"):
            tclip.layer_norm(x, trained, 1e-5)
    assert tln.layer_norm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,dtype", [
    (2 * 592 + 1, 2736, 2730, torch.bfloat16),
    (513, 2736, 2730, torch.float32), (99, 88, 85, torch.bfloat16)],
    ids=["2736-2730", "f32-2736-2730", "88-85"])
def test_logical_width_on_the_card(card, rows, k, n, dtype):
    """The masked kernels (LN_ffn's stored row, and the warp route with an
    odd n) against the plain version at the same width within FWD_BOUND,
    dx against autograd through it as the full-width backward's; y and dx
    exactly 0 past n; the padding, filled, read by neither."""
    x, p, dy = inputs(rows, k, dtype, card, seed=k + n)
    leaf = x.clone().requires_grad_(True)
    want = tln.layer_norm_plain(leaf, p["scale"], p["bias"], 1e-6,
                                width=n)
    (want_dx,) = torch.autograd.grad(want, leaf, dy)
    before = tln.layer_norm.launches, tln.layer_norm.strided_launches
    got = tclip.layer_norm(leaf, p, 1e-6, n)
    (got_dx,) = torch.autograd.grad(got, leaf, dy)
    assert (tln.layer_norm.launches - before[0],
            tln.layer_norm.strided_launches - before[1]) == (2, 2)
    assert not got[:, n:].any() and not got_dx[:, n:].any()
    _within(got, want, *FWD_BOUND[dtype])
    _within(got_dx, want_dx, *((2.0 ** -7, 2.0 ** -12)
                               if dtype == torch.bfloat16 else (0.0, 1e-5)))
    zeroed = x.clone()
    zeroed[:, n:] = 0
    y0, mu, rstd = tln.layer_norm_cuda(zeroed, p["scale"], p["bias"], 1e-6,
                                       True, width=n)
    assert torch.equal(y0, got)
    assert torch.equal(tln.layer_norm_grad_cuda(zeroed, dy, p["scale"], mu,
                                                rstd, width=n), got_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype", [
    (2 * 592 + 1, 2730, torch.bfloat16), (4 * 592 + 3, 1024, torch.bfloat16),
    (131, 2736, torch.float32)], ids=["2730", "1024", "f32-2736"])
def test_full_logical_width_is_the_unmasked_kernel_on_the_card(card, rows,
                                                               k, dtype):
    """n = K runs the unmasked kernels, the calls every CLIP layernorm
    makes: the bits of the call without a width, forward and dx, and no
    strided launch."""
    x, p, dy = inputs(rows, k, dtype, card, seed=k + 3)
    leaf = x.clone().requires_grad_(True)
    before = tln.layer_norm.strided_launches
    outs = []
    for width in (None, k):
        y = tclip.layer_norm(leaf, p, 1e-6, width)
        outs.append((y, *torch.autograd.grad(y, leaf, dy)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert tln.layer_norm.strided_launches == before
