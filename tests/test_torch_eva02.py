"""The port's EVA02 vision tower (`models/eva02.py`, `ops/rope.py`,
`ops/swiglu.py`) against the benchmark's plain float32 reference of
EVA02-CLIP (`benchmark/reference/arch/eva02.py`) on seeded weights, at the
`eva02-tiny` size on the CPU; and the CLIP paths as they were.

- The weight draw: the reference's `draw_weights` gives the port's
  initializer's values, leaf for leaf.
- Features and the TTL step: the port in float32 against the reference on
  the same weights (the layernorms' scales and shifts moved off 1 and 0, so
  that they count), views, adapters and classes: the features, the
  zero-shot and the adapted logits within 1e-4 (the same float32 math
  summed in another order through 4 layers, the bound of
  tests/test_torch_clip.py; the adapted logits read 2.7e-5 apart, the step
  moves them by 10).
- RoPE against the angle formula evaluated directly: the class token and
  pad rows as they were, dims [0, D/2) turned by the patch's row and
  [D/2, D) by its column, pairs interleaved.
- SwiGLU's plain forward and hand backward against autograd of
  F.silu(u) * g.
- The launch counts of one step: `rope.launches` (a q or a k), and
  `swiglu.launches` (a forward or a backward); folded calls and attention
  calls at the tower's depth.
- The modes this tower refuses raise ValueError naming them.
- The card's layout (`card_layout`): the MLP padded from 85 to 88 columns
  as [W1 | 0 | W2 | 0], w3's rows and LN_ffn's scale and bias with zeros,
  every other leaf as it was; an aligned width left alone; the padded tower
  gives the unpadded one's features and LoRA gradients within f32
  rounding, on the CPU and (`cuda`-marked) on the card, where
  `init_clip_params` lays the tower out so.
- CLIP: the text tower's activation is a switch whose default changes
  nothing; the tiny CLIP logits are the values the port gave before the
  EVA02 tower was added, bit for bit; the full-depth launch counts are as
  they were.
- Both towers through the one ViT skeleton: the tiny EVA02 step's logits,
  and CoCoOp's frozen tower (`fold="f32"`) of either tower under either
  TTL_LN_STATS, are the values the port gave while each tower had its own
  skeleton, bit for bit.
"""
import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_threads  # noqa: F401  (torch threads per worker)
from benchmark.harness.manifest import architecture
from benchmark.reference import model as ref_model
from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models import eva02 as teva
from ttl_tpu_torch.models.zoo import EVA02_TINY, TEST_TINY
from ttl_tpu_torch.ops import quant as tq
from ttl_tpu_torch.ops import rope as trope
from ttl_tpu_torch.ops import swiglu as tsw
from ttl_tpu_torch.runner import check_model_axis, load_model, make_adapters0

REF = architecture({"architecture": "eva02"})
SEED = 2 ** 31 + 12345


def ref_config(vcfg=EVA02_TINY.vision, tcfg=EVA02_TINY.text,
               dtype="float32", window=(1, 3)):
    """The benchmark configuration of a port architecture."""
    return {
        "vision": {"hidden_size": vcfg.hidden,
                   "num_hidden_layers": vcfg.layers,
                   "num_attention_heads": vcfg.heads,
                   "intermediate_size": vcfg.mlp_hidden,
                   "patch_size": vcfg.patch, "image_size": vcfg.image_size,
                   "rope_theta": vcfg.rope_theta,
                   "rope_pretrain_grid": vcfg.rope_pretrain_grid},
        "text": {"hidden_size": tcfg.hidden,
                 "num_hidden_layers": tcfg.layers,
                 "num_attention_heads": tcfg.heads,
                 "intermediate_size": tcfg.hidden * tcfg.mlp_ratio,
                 "vocab_size": tcfg.vocab,
                 "max_position_embeddings": tcfg.ctx},
        "projection_dim": vcfg.proj_dim,
        "logit_scale_init": math.log(1 / 0.07),
        "ttl": {"views": 8, "lora_rank": 16, "lora_alpha": 32,
                "lora_init": "xavier", "steps": 1, "lr": 5e-3,
                "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01,
                "deyo_margin_e0": 0.4, "sample_batch": 2,
                "compute_dtype": dtype, "param_dtype": dtype,
                "lora_layers": list(window)},
    }


def ttl_config(arch="eva02-tiny", dtype="float32", **kw):
    return TTLConfig(arch=arch, seed=SEED, resolution=64, sample_batch=2,
                     batch_size=8, compute_dtype=dtype, param_dtype=dtype,
                     **kw)


def to_reference(vision):
    """The port's vision tree in the reference's layout (q, k, v and w1, w2
    apart)."""
    layers = vision["layers"]
    d = layers["o"]["w"].shape[-1]
    q, k, v = layers["qkv"]["w"].split(d, dim=-1)
    bq, bk, bv = layers["qkv"]["b"].split(d, dim=-1)
    assert not bk.any()                                  # no k bias
    w1, w2 = layers["w12"]["w"].chunk(2, dim=-1)
    b1, b2 = layers["w12"]["b"].chunk(2, dim=-1)
    out = {k_: vision[k_] for k_ in vision if k_ != "layers"}
    out["layers"] = {
        "q": {"w": q, "b": bq}, "k": {"w": k}, "v": {"w": v, "b": bv},
        "o": layers["o"], "w1": {"w": w1, "b": b1}, "w2": {"w": w2, "b": b2},
        "w3": layers["w3"], "ln1": layers["ln1"],
        "ln_attn": layers["ln_attn"], "ln2": layers["ln2"],
        "ln_ffn": layers["ln_ffn"]}
    return tclip.tree_map(lambda t: t.float(), out)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def tiny():
    """Port params (layernorms moved off 1/0) at float32, the reference's
    copy, views, classes and fresh adapters."""
    cfg = ttl_config()
    clip_cfg, params = load_model(cfg, "cpu")
    g = torch.Generator().manual_seed(5)

    def moved(t, path):
        if "/ln" in path and path.endswith("scale"):
            return 1 + 0.2 * torch.randn(t.shape, generator=g)
        if "/ln" in path and path.endswith("bias"):
            return 0.2 * torch.randn(t.shape, generator=g)
        return t

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return moved(tree, path)

    params = {**params, "vision": walk(params["vision"])}
    ref = {"vision": to_reference(params["vision"]),
           "logit_scale": params["logit_scale"]}
    views = torch.randn(2, 8, 3, 64, 64, generator=g)
    classes = F.normalize(torch.randn(10, 16, generator=g), dim=-1)
    return cfg, clip_cfg, params, ref, views, classes, \
        make_adapters0(cfg, clip_cfg, "cpu")


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_draws_the_ports_weights(dtype):
    _, params = load_model(ttl_config(dtype=dtype), "cpu")
    want = REF.draw_weights(ref_config(dtype=dtype), SEED)
    got = to_reference(params["vision"])
    assert sorted(p for p, _ in leaves(got)) == \
        sorted(p for p, _ in leaves(want["vision"]))
    for (path, a), (_, b) in zip(leaves(got), leaves(want["vision"])):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(leaves(params["text"]),
                                 leaves(want["text"])):
        assert torch.equal(a.float(), b), path
    assert params["vision"]["layers"]["qkv"]["b"].any()  # biases drawn


# ------------------------------------------------------- against reference

def test_features_match_the_reference(tiny):
    cfg, clip_cfg, params, ref, views, _, _ = tiny
    images = views[0]
    got = tclip.encode_image(params["vision"], images, clip_cfg.vision,
                             compute_dtype=torch.float32)
    want = REF.vision_rest(ref["vision"], REF.vision_prefix(
        ref["vision"], images, ref_config()["vision"], 2, mm=ref_model.exact),
        ref_config()["vision"], 2, mm=ref_model.exact)
    assert got.shape == want.shape == (8, 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_text_tower_matches_the_reference(tiny):
    _, clip_cfg, params, _, _, _, _ = tiny
    ref_text = REF.draw_weights(ref_config(), SEED)["text"]
    tokens = torch.randint(1, 4000, (5, 9),
                           generator=torch.Generator().manual_seed(3))
    tokens[:, -1] = 49407
    got = tclip.text_features(params["text"], tokens, clip_cfg.text,
                              compute_dtype=torch.float32)
    want = REF.text_classifier(ref_text, tokens, ref_config()["text"],
                               mm=ref_model.exact)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    quick = tclip.text_features(params["text"], tokens,
                                TEST_TINY.text, compute_dtype=torch.float32)
    assert (quick - got).abs().max() > 1e-3    # the activation counts


def test_ttl_step_matches_the_reference(tiny):
    cfg, clip_cfg, params, ref, views, classes, adapters0 = tiny
    res = make_batched_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)(
        params, classes, adapters0, views)
    adapted, zero_shot = ref_model.ttl_logits(
        REF, ref, ref_config(), views, classes, adapters0)
    torch.testing.assert_close(res.zero_shot_logits, zero_shot, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(res.logits, adapted, rtol=1e-4, atol=1e-4)
    assert (adapted - zero_shot).abs().max() > 1e-2   # the step moved them


# ----------------------------------------------------------- card layout

def test_card_layout_pads_the_mlp_with_zeros(tiny):
    _, clip_cfg, params, _, _, _, _ = tiny
    vision = params["vision"]
    f = clip_cfg.vision.mlp_hidden
    assert (f, teva.mlp_stride(f)) == (85, 88)
    padded = teva.card_layout(vision, clip_cfg.vision)
    layers, new = vision["layers"], padded["layers"]
    for name in ("w", "b"):
        w1, w2 = layers["w12"][name].split(f, dim=-1)
        p1, z1, p2, z2 = new["w12"][name].split([f, 3, f, 3], dim=-1)
        assert torch.equal(p1, w1) and torch.equal(p2, w2)
        assert not z1.any() and not z2.any()
    assert new["w3"]["w"].shape == (4, 88, 32)
    assert torch.equal(new["w3"]["w"][:, :f], layers["w3"]["w"])
    assert not new["w3"]["w"][:, f:].any()
    assert new["w3"]["b"] is layers["w3"]["b"]
    for name in ("scale", "bias"):
        assert new["ln_ffn"][name].shape == (4, 88)
        assert torch.equal(new["ln_ffn"][name][:, :f],
                           layers["ln_ffn"][name])
        assert not new["ln_ffn"][name][:, f:].any()
    for name in set(layers) - {"w12", "w3", "ln_ffn"}:
        assert new[name] is layers[name], name
    assert all(padded[k] is vision[k] for k in vision if k != "layers")


@pytest.mark.parametrize("f", [88, 2736])
def test_card_layout_leaves_an_aligned_width_as_it_is(f):
    vcfg = teva.EVA02VisionConfig(hidden=32, layers=2, heads=2, proj_dim=16,
                                  patch=16, image_size=64, mlp_hidden=f,
                                  rope_pretrain_grid=2)
    vision = teva.init_vision(torch.Generator().manual_seed(1), vcfg)
    assert teva.mlp_stride(f) == f
    assert teva.card_layout(vision, vcfg) is vision


def _features_and_lora_grads(vision, clip_cfg, images, adapters):
    """f32 features of the adapted tower (window 1-3) and the gradient of
    their squares' sum with respect to every adapter leaf."""
    leaves_ = []
    tclip.tree_map(leaves_.append, adapters)
    feats = tclip.encode_image(vision, images, clip_cfg.vision,
                               compute_dtype=torch.float32,
                               adapters=adapters, adapter_window=(1, 3))
    return feats, torch.autograd.grad(feats.square().sum(), leaves_)


def _moved_adapters(adapters0, device="cpu"):
    """Adapters moved off their initial values (B starts at zero), so that
    every leaf takes a gradient."""
    g = torch.Generator().manual_seed(17)
    return tclip.tree_map(
        lambda t: (t + 0.05 * torch.randn(t.shape, generator=g)).to(
            device).requires_grad_(True), adapters0)


def test_padded_tower_gives_the_unpadded_features_and_lora_gradients(tiny):
    """On the CPU, the padded layout through the same code: the products
    sum the same terms and zeros, so features and gradients agree to f32
    rounding."""
    _, clip_cfg, params, _, views, _, adapters0 = tiny
    adapters = _moved_adapters(adapters0)
    padded = teva.card_layout(params["vision"], clip_cfg.vision)
    want, want_grads = _features_and_lora_grads(params["vision"], clip_cfg,
                                                views[0], adapters)
    got, grads = _features_and_lora_grads(padded, clip_cfg, views[0],
                                          adapters)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for a, b in zip(grads, want_grads):
        assert b.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())


# ------------------------------------------------------------------ RoPE

@pytest.mark.parametrize("vcfg", [EVA02_TINY.vision, teva.EVA02VisionConfig(
    hidden=1024, layers=24, heads=16, proj_dim=768, patch=14,
    image_size=336)], ids=["tiny", "l14-336"])
def test_rope_tables_follow_the_angle_formula(vcfg):
    g, d = vcfg.grid, vcfg.hidden // vcfg.heads
    seq = ((vcfg.seq_len + 15) // 16) * 16
    cos, sin = trope.rope_tables(g, vcfg.rope_pretrain_grid, d,
                                 vcfg.rope_theta, seq, torch.device("cpu"))
    assert cos.shape == sin.shape == (seq, 1, d)
    want_cos = np.ones((seq, d))
    want_sin = np.zeros((seq, d))
    for n in range(g * g):
        r, c = divmod(n, g)
        for dim in range(d):
            pos = r if dim < d // 2 else c
            j = (dim % (d // 2)) // 2
            angle = pos * (vcfg.rope_pretrain_grid / g) \
                * vcfg.rope_theta ** (-2 * j / (d // 2))
            want_cos[n + 1, dim] = math.cos(angle)
            want_sin[n + 1, dim] = math.sin(angle) * (-1 if dim % 2 == 0
                                                      else 1)
    np.testing.assert_allclose(cos[:, 0].numpy(), want_cos, atol=1e-6)
    np.testing.assert_allclose(sin[:, 0].numpy(), want_sin, atol=1e-6)


def test_rope_turns_each_pair_of_the_patch_tokens():
    vcfg = EVA02_TINY.vision
    heads, d = vcfg.heads, vcfg.hidden // vcfg.heads
    seq = 32                                   # 17 tokens padded
    cos, sin = trope.rope_tables(vcfg.grid, vcfg.rope_pretrain_grid, d,
                                 vcfg.rope_theta, seq, torch.device("cpu"))
    t = torch.randn(3, seq, heads * d,
                    generator=torch.Generator().manual_seed(1))
    got = trope.rope(t, cos, sin, heads).unflatten(-1, (heads, d))
    x = t.unflatten(-1, (heads, d))
    assert torch.equal(got[:, 0], x[:, 0])              # the class token
    assert torch.equal(got[:, 17:], x[:, 17:])          # pad rows
    g, p0 = vcfg.grid, vcfg.rope_pretrain_grid
    for n in (0, 5, 15):
        r, c = divmod(n, g)
        for i in range(d // 2):
            pos = r if 2 * i < d // 2 else c
            j = i % (d // 4)
            a = pos * p0 / g * vcfg.rope_theta ** (-2 * j / (d // 2))
            e, o = x[:, n + 1, :, 2 * i], x[:, n + 1, :, 2 * i + 1]
            torch.testing.assert_close(
                got[:, n + 1, :, 2 * i], e * math.cos(a) - o * math.sin(a),
                rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(
                got[:, n + 1, :, 2 * i + 1],
                o * math.cos(a) + e * math.sin(a), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- SwiGLU

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -8)],
                         ids=["f32", "bf16"])
def test_swiglu_forward_and_backward_against_autograd(dtype, tol):
    """bf16: both sides round one f32 value once, and autograd's rounds
    SiLU(u) and the product apart: one bf16 step of the output apart."""
    g = torch.Generator().manual_seed(2)
    gu = (torch.randn(7, 2 * 85, generator=g) * 3).to(dtype)
    dy = torch.randn(7, 85, generator=g).to(dtype)
    leaf = gu.float().requires_grad_(True)
    u, gate = leaf.chunk(2, dim=-1)
    want = F.silu(u) * gate
    (want_grad,) = torch.autograd.grad(want, leaf, dy.float())
    got = tsw.swiglu_plain(gu)
    grad = tsw.swiglu_grad_plain(gu, dy)
    assert got.dtype == grad.dtype == dtype
    scale = want.abs().max().item()
    torch.testing.assert_close(got.float(), want.detach(), rtol=tol,
                               atol=tol * scale)
    torch.testing.assert_close(grad.float(), want_grad, rtol=tol,
                               atol=tol * want_grad.abs().max().item())
    x = gu.clone().requires_grad_(True)
    before = tsw.swiglu.launches
    out = tsw.swiglu(x)
    (through,) = torch.autograd.grad(out, x, dy)
    assert tsw.swiglu.launches - before == 2          # forward, backward
    assert torch.equal(out, got) and torch.equal(through, grad)


# ---------------------------------------------------------------- counts

def _counting(monkeypatch, module):
    """Count the folded calls (by epilogue) and the attention calls of
    `module`'s layers, and the attention outputs a gradient flows back
    through (a checkpointed layer's forward run again in the backward is
    a call, and not a backward)."""
    calls = {"folded": [], "fwd": 0, "bwd": 0}
    real_ln, real_attn = module.ln_matmul, module.attention

    def ln_matmul(x, *args, **kw):
        calls["folded"].append(kw.get("epilogue", "f32"))
        return real_ln(x, *args, **kw)

    def attention(q, k, v, *args, **kw):
        calls["fwd"] += 1
        out = real_attn(q, k, v, *args, **kw)
        if out.requires_grad:
            out.register_hook(lambda g: calls.__setitem__("bwd",
                                                          calls["bwd"] + 1))
        return out

    monkeypatch.setattr(module, "ln_matmul", ln_matmul)
    monkeypatch.setattr(module, "attention", attention)
    return calls


def _step(clip_cfg, dtype="bfloat16", views=4):
    cfg = TTLConfig(arch="test-tiny", seed=3, resolution=64, sample_batch=2,
                    batch_size=views, compute_dtype=dtype, param_dtype=dtype)
    params = tclip.init_clip_params(clip_cfg, torch.Generator().manual_seed(
        3), device="cpu", param_dtype=getattr(torch, dtype))
    adapters0 = make_adapters0(cfg, clip_cfg, "cpu")
    classes = F.normalize(torch.randn(5, 16), dim=-1)
    images = torch.randn(2, views, 3, 64, 64)
    return make_batched_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)(
        params, classes, adapters0, images)


@pytest.mark.parametrize("layers", [4, 24])
def test_eva02_counts_of_a_step(layers, monkeypatch):
    """At depth L, window [L-3, L-1]: RoPE twice and SwiGLU once in each
    layer's forward (the prefix, the window, its forward again in the
    backward, the clean and zero-shot passes), SwiGLU once more in each
    window layer's backward; two folded calls in each prefix layer, with
    `linear`'s epilogue."""
    clip_cfg = tclip.CLIPConfig(
        vision=teva.EVA02VisionConfig(
            hidden=32, layers=layers, heads=2, proj_dim=16, patch=16,
            image_size=64, mlp_hidden=85, rope_pretrain_grid=2),
        text=EVA02_TINY.text)
    calls = _counting(monkeypatch, teva)
    rope0, swiglu0 = trope.rope.launches, tsw.swiglu.launches
    _step(clip_cfg)
    prefix = layers - 3
    assert trope.rope.launches - rope0 == 2 * (prefix + 12)
    assert tsw.swiglu.launches - swiglu0 == prefix + 15
    assert calls["folded"] == ["linear"] * 2 * prefix
    assert (calls["fwd"], calls["bwd"]) == (layers + 9, 3)
    if layers == 24:        # the L/14 step's: 66 and 36; K6 42, K1 33, K2 3
        assert 2 * (prefix + 12) == 66 and prefix + 15 == 36


@pytest.mark.parametrize("layers,folded,fwd", [(12, 36, 18), (24, 84, 30)],
                         ids=["vitb16-depth", "vitl14-depth"])
def test_clip_counts_of_a_step_are_unchanged(layers, folded, fwd,
                                             monkeypatch):
    clip_cfg = tclip.CLIPConfig(
        vision=tclip.VisionConfig(hidden=32, layers=layers, heads=2,
                                  proj_dim=16, patch=16, image_size=64),
        text=TEST_TINY.text)
    calls = _counting(monkeypatch, tclip)
    rope0, swiglu0 = trope.rope.launches, tsw.swiglu.launches
    _step(clip_cfg)
    assert calls["folded"] == ["linear"] * folded
    assert (calls["fwd"], calls["bwd"]) == (fwd, 3)
    assert (trope.rope.launches, tsw.swiglu.launches) == (rope0, swiglu0)


# sha256 (first 16 hex digits) of the tiny CLIP step's float32 values on
# one thread, as the port computed them before the EVA02 tower was added
CLIP_BITS = {
    ("float32", "text"): "f428d2251f2fe12a",
    ("float32", "adapted"): "8dd0702cabe54895",
    ("float32", "zero_shot"): "5b8bf9e975a96eda",
    ("bfloat16", "text"): "6db2301806258e07",
    ("bfloat16", "adapted"): "fbd29d776c3a0195",
    ("bfloat16", "zero_shot"): "e5e7f92943302c08",
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_tiny_logits_are_bit_for_bit_as_before(dtype):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = TTLConfig(arch="test-tiny", seed=7, resolution=64,
                        sample_batch=2, batch_size=8, compute_dtype=dtype,
                        param_dtype=dtype)
        clip_cfg, params = load_model(cfg, "cpu")
        adapters0 = make_adapters0(cfg, clip_cfg, "cpu")
        g = torch.Generator().manual_seed(11)
        tokens = torch.randint(1, 400, (6, 9), generator=g)
        tokens[:, -1] = 49407
        txt = tclip.text_features(params["text"], tokens, clip_cfg.text,
                                  compute_dtype=getattr(torch, dtype))
        classes = F.normalize(txt.float(), dim=-1)
        views = torch.randn(2, 8, 3, 64, 64, generator=g)
        res = make_batched_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)(
            params, classes, adapters0, views)
    finally:
        torch.set_num_threads(threads)
    for name, t in (("text", txt), ("adapted", res.logits),
                    ("zero_shot", res.zero_shot_logits)):
        assert _digest(t) == CLIP_BITS[(dtype, name)], name


def _digest(t):
    """sha256 (first 16 hex digits) of t's float32 values."""
    return hashlib.sha256(
        t.detach().float().contiguous().numpy().tobytes()).hexdigest()[:16]


# the same digests of the tiny EVA02 step, and of CoCoOp's frozen vision
# tower (`encode_image` under its "f32" fold request) under either
# TTL_LN_STATS, as the port computed them before the ViT towers shared one
# skeleton
EVA02_BITS = {
    ("float32", "adapted"): "65f03967347c027b",
    ("float32", "zero_shot"): "e34f975224d9b4da",
    ("bfloat16", "adapted"): "903a9b61f7313cd3",
    ("bfloat16", "zero_shot"): "2fc0773d26be0ea5",
}
COCOOP_TOWER_BITS = {
    ("test-tiny", "centered", "float32"): "f46adeeb02f69e67",
    ("test-tiny", "centered", "bfloat16"): "2b3040334b86e790",
    ("test-tiny", "ex2", "float32"): "f32535f695ada68b",
    ("test-tiny", "ex2", "bfloat16"): "2b3040334b86e790",
    ("eva02-tiny", "centered", "float32"): "d4821cf35eba5333",
    ("eva02-tiny", "centered", "bfloat16"): "1f5cb98800114d2b",
    ("eva02-tiny", "ex2", "float32"): "3819808a07ade763",
    ("eva02-tiny", "ex2", "bfloat16"): "1f5cb98800114d2b",
}


def _moved(tree, g, path=""):
    """tree with its layernorms' scales and shifts and its biases moved off
    1 and 0, so that an epilogue's roundings of the bias show."""
    if isinstance(tree, dict):
        return {k: _moved(v, g, f"{path}/{k}") for k, v in tree.items()}
    if path.endswith("/scale"):
        return (1 + 0.2 * torch.randn(tree.shape, generator=g)).to(tree.dtype)
    if path.endswith(("/bias", "/b")):
        return (0.2 * torch.randn(tree.shape, generator=g)).to(tree.dtype)
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eva02_tiny_logits_are_bit_for_bit_as_before(dtype):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = ttl_config(dtype=dtype)
        clip_cfg, params = load_model(cfg, "cpu")
        g = torch.Generator().manual_seed(11)
        classes = F.normalize(torch.randn(6, 16, generator=g), dim=-1)
        views = torch.randn(2, 8, 3, 64, 64, generator=g)
        res = make_batched_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)(
            params, classes, make_adapters0(cfg, clip_cfg, "cpu"), views)
    finally:
        torch.set_num_threads(threads)
    for name, t in (("adapted", res.logits),
                    ("zero_shot", res.zero_shot_logits)):
        assert _digest(t) == EVA02_BITS[(dtype, name)], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats", ["centered", "ex2"])
@pytest.mark.parametrize("arch", ["test-tiny", "eva02-tiny"])
def test_cocoop_frozen_tower_is_bit_for_bit_as_before(arch, stats, dtype,
                                                      monkeypatch):
    monkeypatch.setenv("TTL_LN_STATS", stats)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = ttl_config(arch=arch, dtype=dtype)
        clip_cfg, params = load_model(cfg, "cpu")
        vision = _moved(params["vision"], torch.Generator().manual_seed(13))
        views = torch.randn(6, 3, 64, 64,
                            generator=torch.Generator().manual_seed(13))
        with torch.no_grad():
            feats = tclip.encode_image(vision, views,
                                       clip_cfg.vision,
                                       compute_dtype=getattr(torch, dtype),
                                       fold="f32")
    finally:
        torch.set_num_threads(threads)
    assert _digest(feats) == COCOOP_TOWER_BITS[(arch, stats, dtype)]


# --------------------------------------------------------- refused modes

def test_int8_prefix_and_model_axis_raise(tiny):
    cfg, clip_cfg, _, _, _, _, _ = tiny
    with pytest.raises(ValueError, match="int8"):
        tq.quant_prefix_len(cfg, clip_cfg)
    with pytest.raises(ValueError, match="int8"):
        load_model(ttl_config(prefix_quant="int8"), "cpu")
    with pytest.raises(ValueError, match="model axis"):
        load_model(ttl_config(mesh_shape=(1, 2)), "cpu")
    with pytest.raises(ValueError, match="model axis"):
        check_model_axis(clip_cfg, (2, 2))


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SwiGLU kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f,dtype", [
    (8 * 592, 2730, torch.bfloat16), (1001, 85, torch.bfloat16),
    (513, 2730, torch.float32)], ids=["step-bf16", "odd-bf16", "f32"])
def test_swiglu_kernels_against_the_plain_versions(card, rows, f, dtype):
    """Each output within one bf16 step (f32: 1e-5) of the plain version's,
    which rounds the same f32 value: the kernel's fast exponential and
    reciprocal move that value by a few units in its last place; du's
    (1 + u (1 - sig)) cancels near u = -1.28, hence the floor at 2^-16 of
    the largest output."""
    rel, floor = (2.0 ** -7, 2.0 ** -16) if dtype == torch.bfloat16 \
        else (1e-5, 1e-6)
    g = torch.Generator().manual_seed(rows)
    gu = (torch.randn(rows, 2 * f, generator=g) * 3).to(card, dtype)
    dy = torch.randn(rows, f, generator=g).to(card, dtype)
    x = gu.clone().requires_grad_(True)
    before = tsw.swiglu.launches
    out = tsw.swiglu(x)
    (grad,) = torch.autograd.grad(out, x, dy)
    assert tsw.swiglu.launches - before == 2
    for got, want in ((out, tsw.swiglu_plain(gu)),
                      (grad, tsw.swiglu_grad_plain(gu, dy))):
        got, want = got.float(), want.float()
        limit = rel * want.abs() + floor * want.abs().max()
        assert ((got - want).abs() <= limit).all()


@pytest.mark.cuda
def test_card_layout_on_the_card(card):
    """`init_clip_params` on the card lays the tower out padded and the
    CPU's draw stays unpadded. At an even SwiGLU width (86 -> 88), which
    the layernorm kernels take unpadded too, the card's padded tower gives
    its unpadded tower's f32 features and LoRA gradients within f32
    rounding, LN_ffn's forwards and backwards counted as strided launches;
    at `eva02-tiny`'s odd 85, which only the padded layout runs on the
    card, they are the CPU's within the reference tests' 1e-4."""
    from ttl_tpu_torch.ops import layer_norm as tln
    cfg = ttl_config()
    even = tclip.CLIPConfig(
        vision=dataclasses.replace(EVA02_TINY.vision, mlp_hidden=86),
        text=EVA02_TINY.text)
    images = torch.randn(8, 3, 64, 64,
                         generator=torch.Generator().manual_seed(3))
    adapters0 = make_adapters0(cfg, EVA02_TINY, "cpu")
    for clip_cfg, f in ((even, 86), (EVA02_TINY, 85)):
        on_card = tclip.init_clip_params(
            clip_cfg, torch.Generator().manual_seed(SEED), device=card)
        on_host = tclip.init_clip_params(
            clip_cfg, torch.Generator().manual_seed(SEED), device="cpu")
        assert on_card["vision"]["layers"]["w12"]["w"].shape == (4, 32, 176)
        assert on_host["vision"]["layers"]["w12"]["w"].shape == (4, 32, 2 * f)
        padded = tclip.tree_map(lambda t: t.to(card), teva.card_layout(
            on_host["vision"], clip_cfg.vision))
        for (path, a), (_, b) in zip(leaves(on_card["vision"]),
                                     leaves(padded)):
            assert torch.equal(a, b), path
        before = tln.layer_norm.strided_launches
        got, grads = _features_and_lora_grads(
            on_card["vision"], clip_cfg, images.to(card),
            _moved_adapters(adapters0, card))
        # LN_ffn of the prefix's layer forward; of the window's 3 forward,
        # again in the recompute, and backward
        assert tln.layer_norm.strided_launches - before == 1 + 3 * 3
        if f == 86:
            rtol, atol, gtol, where = 1e-5, 1e-6, 1e-5, card
            vision = tclip.tree_map(lambda t: t.to(card), on_host["vision"])
        else:
            rtol, atol, gtol, where = 1e-4, 1e-4, 1e-4, "cpu"
            vision = on_host["vision"]
        want, want_grads = _features_and_lora_grads(
            vision, clip_cfg, images.to(where),
            _moved_adapters(adapters0, where))
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=rtol,
                                   atol=atol)
        for a, b in zip(grads, want_grads):
            torch.testing.assert_close(
                a.cpu(), b.cpu(), rtol=rtol,
                atol=gtol * b.abs().max().item())
