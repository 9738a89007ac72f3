"""The port's AIMv2 towers (`models/aimv2.py`), the RMS statistics of the
layernorm kernels and of K6 (`ops/layer_norm.py`, `ops/ln_matmul.py`) and
K1/K2 at head dim 128, against the benchmark's plain float32 reference of
AIMv2-L/14 LiT (`benchmark/reference/arch/lit_aimv2.py`) on seeded weights,
at the `aimv2-tiny` size (256 wide, 2 heads of 128, 4 layers, SwiGLU 704,
a 4 x 4 grid) on the CPU.

- The weight draw: the reference's `draw_weights` gives the port's
  initializer's values, leaf for leaf.
- Against the reference, in float32, on the same weights (the RMSNorm
  scales and the biases moved off 1 and 0, so that they count): the vision
  features with and without adapters, LoRA's gradients through the window
  and the pooling head, the class table from the text tower, the TTL
  step's zero-shot and adapted logits; within 1e-4 (the same float32 math
  summed in another order through 4 layers, the bound of
  tests/test_torch_eva02.py); gradients within 1e-4 of their largest.
- The plain RMS forward and dx against autograd of the formula, and K6's
  plain RMS prologue against the unfolded chain, bit for bit.
- The plain attention at head dim 128 against the softmax written out in
  float64.
- A tower without a class token: `seq_len` is the grid's tokens.
- The launch counts of a step; `predict_directory`, the serving predictor
  and the runner (image and text LoRA) at `--arch aimv2-tiny`; the modes
  the towers refuse.
- On the card (`cuda`-marked): K1/K2 at head dim 128, the RMS layernorm
  kernels and K6's RMS prologue against their plain versions, and the
  centered and ex2 codes on CLIP's and EVA02's shapes within the bounds
  `tests/test_torch_layer_norm.py` holds them to.
"""
import math

import pytest
import torch
import torch.nn.functional as F

import test_torch_threads  # noqa: F401  (torch threads per worker)
from test_torch_layer_norm import FWD_BOUND, _within, inputs
from benchmark.harness.manifest import architecture
from benchmark.reference import model as ref_model
from ttl_tpu_torch.adapt.ttl import make_batched_ttl_fn
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models import aimv2 as taim
from ttl_tpu_torch.models import clip as tclip
from ttl_tpu_torch.models.zoo import AIMV2_TINY, TEST_TINY, get_arch
from ttl_tpu_torch.ops import attention as tfa
from ttl_tpu_torch.ops import layer_norm as tln
from ttl_tpu_torch.ops import ln_matmul as tlm
from ttl_tpu_torch.ops import quant as tq
from ttl_tpu_torch.ops import swiglu as tsw
from ttl_tpu_torch.runner import check_model_axis, load_model, make_adapters0

REF = architecture({"architecture": "lit_aimv2"})
SEED = 2 ** 31 + 22345


def ref_config(dtype="float32", window=(1, 3)):
    """The benchmark configuration of the tiny towers."""
    v, t = AIMV2_TINY.vision, AIMV2_TINY.text
    return {
        "vision": {"hidden_size": v.hidden, "num_hidden_layers": v.layers,
                   "num_attention_heads": v.heads,
                   "intermediate_size": v.mlp_hidden,
                   "patch_size": v.patch, "image_size": v.image_size,
                   "rms_norm_eps": v.ln_eps},
        "text": {"hidden_size": t.hidden, "num_hidden_layers": t.layers,
                 "num_attention_heads": t.heads,
                 "intermediate_size": t.mlp_hidden, "vocab_size": t.vocab,
                 "max_position_embeddings": t.ctx, "rms_norm_eps": t.ln_eps},
        "projection_dim": v.proj_dim,
        "logit_scale_init": math.log(1 / 0.07),
        "ttl": {"views": 8, "lora_rank": 16, "lora_alpha": 32,
                "lora_init": "xavier", "steps": 1, "lr": 5e-3,
                "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01,
                "deyo_margin_e0": 0.4, "sample_batch": 2,
                "compute_dtype": dtype, "param_dtype": dtype,
                "lora_layers": list(window)},
    }


def ttl_config(dtype="float32", **kw):
    return TTLConfig(arch="aimv2-tiny", seed=SEED, resolution=64,
                     sample_batch=2, batch_size=8, compute_dtype=dtype,
                     param_dtype=dtype, **kw)


def _layers_to_reference(layers):
    d = layers["o"]["w"].shape[-1]
    q, k, v = layers["qkv"]["w"].split(d, dim=-1)
    wg, wu = layers["w12"]["w"].chunk(2, dim=-1)
    return {"q": {"w": q}, "k": {"w": k}, "v": {"w": v}, "o": layers["o"],
            "wg": {"w": wg}, "wu": {"w": wu}, "wd": layers["w3"],
            "ln1": layers["ln1"], "ln2": layers["ln2"]}


def to_reference(tower):
    """A port tower's tree (vision or text) in the reference's layout: q, k,
    v, Wg, Wu and Wk', Wv' apart, every leaf float32."""
    out = {k: tower[k] for k in tower if k not in ("layers", "pool_kv")}
    out["layers"] = _layers_to_reference(tower["layers"])
    if "pool_kv" in tower:
        wk, wv = tower["pool_kv"]["w"].chunk(2, dim=-1)
        out.update(pool_k={"w": wk}, pool_v={"w": wv})
    return tclip.tree_map(lambda t: t.float(), out)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _moved(tree, g, path=""):
    """tree with its RMSNorm scales and its biases moved off 1 and 0."""
    if isinstance(tree, dict):
        return {k: _moved(v, g, f"{path}/{k}") for k, v in tree.items()}
    if path.endswith("/scale"):
        return (1 + 0.2 * torch.randn(tree.shape, generator=g)).to(tree.dtype)
    if path.endswith("/b"):
        return (0.2 * torch.randn(tree.shape, generator=g)).to(tree.dtype)
    return tree


@pytest.fixture(scope="module")
def tiny():
    """Port params (norm scales and biases moved) at float32, the
    reference's copy, views, classes and fresh adapters."""
    cfg = ttl_config()
    clip_cfg, params = load_model(cfg, "cpu")
    g = torch.Generator().manual_seed(5)
    params = {**params, "vision": _moved(params["vision"], g),
              "text": _moved(params["text"], g)}
    ref = {"vision": to_reference(params["vision"]),
           "text": to_reference(params["text"]),
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
    for tower in ("vision", "text"):
        got = to_reference(params[tower])
        assert sorted(p for p, _ in leaves(got)) == \
            sorted(p for p, _ in leaves(want[tower]))
        for (path, a), (_, b) in zip(leaves(got), leaves(want[tower])):
            assert torch.equal(a, b), (tower, path)
    assert params["vision"]["pool_out"]["b"].any()       # biases drawn


# ------------------------------------------------------- against reference

def _moved_adapters(adapters0):
    """Adapters moved off their initial values (B starts at zero), so that
    every leaf takes a gradient."""
    g = torch.Generator().manual_seed(17)
    return tclip.tree_map(
        lambda t: (t + 0.05 * torch.randn(t.shape, generator=g))
        .requires_grad_(True), adapters0)


def test_features_match_the_reference(tiny):
    _, clip_cfg, params, ref, views, _, _ = tiny
    images = views[0]
    vcfg = ref_config()["vision"]
    got = tclip.encode_image(params["vision"], images, clip_cfg.vision,
                             compute_dtype=torch.float32)
    hidden = REF.vision_prefix(ref["vision"], images, vcfg, 2,
                               mm=ref_model.exact)
    want = REF.vision_rest(ref["vision"], hidden, vcfg, 2,
                           mm=ref_model.exact)
    assert got.shape == want.shape == (8, 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_adapted_features_and_lora_gradients_match_the_reference(tiny):
    """Window 1-3 with adapters moved off zero: the features, and the
    gradient of their squares' sum with respect to every adapter leaf,
    which flows back through the pooling head and the window."""
    _, clip_cfg, params, ref, views, _, adapters0 = tiny
    images = views[0]
    vcfg = ref_config()["vision"]
    adapters = _moved_adapters(adapters0)
    names = [(m, ab) for m in ("q", "v") for ab in ("A", "B")]
    got = tclip.encode_image(params["vision"], images, clip_cfg.vision,
                             compute_dtype=torch.float32, adapters=adapters,
                             adapter_window=(1, 3))
    grads = torch.autograd.grad(got.square().sum(),
                                [adapters[m][ab] for m, ab in names])
    ref_ad = {m: {ab: adapters[m][ab].detach().unsqueeze(0)
                  .requires_grad_(True) for ab in ("A", "B")}
              for m in ("q", "v")}
    with torch.no_grad():
        hidden = REF.vision_prefix(ref["vision"], images, vcfg, 1,
                                   mm=ref_model.exact)
    want = REF.vision_rest(ref["vision"], hidden, vcfg, 1, ref_ad, 3, 2.0, 1,
                           mm=ref_model.exact)
    want_grads = torch.autograd.grad(want.square().sum(),
                                     [ref_ad[m][ab] for m, ab in names])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    unadapted = tclip.encode_image(params["vision"], images,
                                   clip_cfg.vision,
                                   compute_dtype=torch.float32)
    assert (got - unadapted).abs().max() > 1e-3         # the adapters count
    for (m, ab), a, b in zip(names, grads, want_grads):
        b = b[0]
        assert b.abs().max() > 0, (m, ab)
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item())


def test_class_table_matches_the_reference(tiny):
    _, clip_cfg, params, ref, _, _, _ = tiny
    tokens = torch.randint(1, 4000, (5, 9),
                           generator=torch.Generator().manual_seed(3))
    tokens[:, 6] = 49407                  # the first end-of-text token
    tokens[:, 7:] = 0
    got = tclip.text_features(params["text"], tokens, clip_cfg.text,
                              compute_dtype=torch.float32)
    want = REF.text_classifier(ref["text"], tokens, ref_config()["text"],
                               mm=ref_model.exact)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    embeddings = params["text"]["token_embed"][tokens]
    again = tclip.text_features_from_embeddings(
        params["text"], embeddings, tokens, clip_cfg.text,
        compute_dtype=torch.float32)
    torch.testing.assert_close(again, got, rtol=1e-6, atol=1e-6)


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


# ------------------------------------------------------ RMS and attention

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -8)],
                         ids=["f32", "bf16"])
def test_rms_forward_and_dx_against_autograd(dtype, tol):
    """The plain RMS code against autograd of (x rsqrt(mean(x^2) + eps)) w
    in float32: bf16 rounds the same f32 value once on both sides (one bf16
    step of the output); f32 sums in another order. Through the op, forward
    and dx are the plain versions' bits and both launches count as RMS."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(7, 96, generator=g) * 3 + 1).to(dtype)
    w = 1 + 0.3 * torch.randn(96, generator=g)
    dy = torch.randn(7, 96, generator=g).to(dtype)
    leaf = x.float().requires_grad_(True)
    want = leaf * torch.rsqrt(leaf.square().mean(-1, keepdim=True) + 1e-5) \
        * w
    (want_dx,) = torch.autograd.grad(want, leaf, dy.float())
    y, mu, rstd = tln._plain(x, w, None, 1e-5, "rms")
    dx = tln.layer_norm_grad_plain(x, dy, w, mu, rstd, stats="rms")
    assert y.dtype == dx.dtype == dtype and not mu.any()
    torch.testing.assert_close(y.float(), want.detach(), rtol=tol,
                               atol=tol * want.abs().max().item())
    torch.testing.assert_close(dx.float(), want_dx, rtol=tol,
                               atol=tol * want_dx.abs().max().item())
    xl = x.clone().requires_grad_(True)
    before = (tln.layer_norm.launches, tln.layer_norm.rms_launches)
    out = tln.layer_norm(xl, w, None, 1e-5, "rms")
    (through,) = torch.autograd.grad(out, xl, dy)
    assert torch.equal(out, y) and torch.equal(through, dx)
    assert (tln.layer_norm.launches - before[0],
            tln.layer_norm.rms_launches - before[1]) == (2, 2)
    with pytest.raises(ValueError, match="full width"):
        tln.layer_norm_plain(x, w, None, 1e-5, "rms", width=50)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k6_rms_prologue_is_the_unfolded_chain_bit_for_bit(dtype):
    """The plain K6 with the RMS statistics and no bias is rms_norm then
    linear, on the CPU, bit for bit (the frozen prefix's folded layers give
    the unfolded ones' values); the RMS code takes the linear epilogue
    alone."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 9, 64, generator=g).to(dtype)
    norm = {"scale": 1 + 0.3 * torch.randn(64, generator=g)}
    lin = {"w": (0.1 * torch.randn(64, 48, generator=g)).to(dtype)}
    got = tlm.ln_matmul(x, norm["scale"], None, lin["w"], None, 1e-5,
                        epilogue="linear", stats="rms")
    want = tclip.linear(taim.rms_norm(x, norm, 1e-5), lin)
    assert torch.equal(got, want)
    for kw in (dict(epilogue="f32"), dict(epilogue="linear",
                                          quick_gelu=True)):
        with pytest.raises(ValueError, match="RMS"):
            tlm.ln_matmul(x, norm["scale"], None, lin["w"], None, 1e-5,
                          stats="rms", **kw)


@pytest.mark.parametrize("seq_len", [256, 200])
def test_plain_attention_at_head_dim_128(seq_len):
    """The plain version of K1/K2 (and the dispatcher on the CPU) at head
    dim 128 against the softmax written out in float64, keys at or past
    seq_len masked: f32 scores and softmax against float64, 1e-5."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 256, 2 * 128, generator=g) for _ in range(3))
    got = tfa.attention_bshd_plain(q, k, v, 2, seq_len)
    qh, kh, vh = (t.double().reshape(2, 256, 2, 128).transpose(1, 2)
                  for t in (q, k, v))
    scores = qh @ kh.transpose(-1, -2) / math.sqrt(128)
    scores[..., seq_len:] = -math.inf
    want = (torch.softmax(scores, -1) @ vh).transpose(1, 2).reshape(
        2, 256, 256)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    through = tfa.attention(q, k, v, 2, False,
                            None if seq_len == 256 else seq_len)
    assert torch.equal(through, got)


# ------------------------------------------------------- the tower's shape

def test_seq_len_of_a_tower_without_a_class_token():
    assert AIMV2_TINY.vision.seq_len == 16
    assert get_arch("AIMv2-L-14-224-LiT").vision.seq_len == 256
    assert TEST_TINY.vision.seq_len == 17
    assert get_arch("ViT-L/14").vision.seq_len == 257
    assert not tclip.TOWERS["aimv2"].class_token
    assert tclip.TOWERS["clip"].class_token
    _, params = load_model(ttl_config(), "cpu")
    assert params["vision"]["pos_embed"].shape == (16, 256)
    hidden = tclip.vision_prefix(params["vision"],
                                 torch.randn(3, 3, 64, 64), AIMV2_TINY.vision,
                                 upto=2, compute_dtype=torch.float32)
    assert hidden.shape == (3, 16, 256)


# ----------------------------------------------------------------- counts

def _counting(monkeypatch):
    """Count the folded calls by their statistics and the attention calls
    of the AIMv2 blocks, and send the CPU's norms through the op, so that
    its counters grow."""
    calls = {"folded": [], "fwd": 0}
    real_ln, real_attn = taim.ln_matmul, taim.attention

    def ln_matmul(x, *args, **kw):
        calls["folded"].append(kw.get("stats"))
        return real_ln(x, *args, **kw)

    def attention(*args, **kw):
        calls["fwd"] += 1
        return real_attn(*args, **kw)

    monkeypatch.setattr(taim, "ln_matmul", ln_matmul)
    monkeypatch.setattr(taim, "attention", attention)
    monkeypatch.setattr(tln, "layer_norm_plain", tln.layer_norm)
    return calls


@pytest.mark.parametrize("layers", [4, 24])
def test_counts_of_a_step(layers, monkeypatch):
    """At depth L, window [L-3, L-1], 8 views of 2 images: two folded calls
    with the RMS statistics in each prefix layer; SwiGLU in each layer's
    forward (the prefix, the window, the clean and zero-shot passes) and
    each window layer's backward; every norm of the step on the RMS code:
    RMSNorm_e, six in the window and RMSNorm_f forward, the clean view's two
    passes (seven each), five dx in the window (the first layer's input
    takes no gradient) and RMSNorm_f's. At L = 24, the cell's: K6 42, norms
    28, SwiGLU 33, K1 30."""
    clip_cfg = tclip.CLIPConfig(
        vision=taim.AIMv2VisionConfig(hidden=256, layers=layers, heads=2,
                                      proj_dim=16, patch=16, image_size=64,
                                      mlp_hidden=64),
        text=TEST_TINY.text)
    calls = _counting(monkeypatch)
    cfg = TTLConfig(arch="aimv2-tiny", seed=3, resolution=64, sample_batch=2,
                    batch_size=8, compute_dtype="bfloat16",
                    param_dtype="bfloat16")
    params = tclip.init_clip_params(clip_cfg, torch.Generator().manual_seed(
        3), device="cpu", param_dtype=torch.bfloat16)
    adapters0 = make_adapters0(cfg, clip_cfg, "cpu")
    before = (tln.layer_norm.launches, tln.layer_norm.rms_launches,
              tsw.swiglu.launches)
    make_batched_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)(
        params, F.normalize(torch.randn(5, 16), dim=-1), adapters0,
        torch.randn(2, 8, 3, 64, 64))
    prefix = layers - 3
    norms = tln.layer_norm.launches - before[0]
    assert calls["folded"] == ["rms"] * 2 * prefix
    assert norms == tln.layer_norm.rms_launches - before[1] == 28
    assert tsw.swiglu.launches - before[2] == layers + 6 + 3
    assert calls["fwd"] == layers + 6


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("entry", ["predict", "serve", "runner", "text"])
def test_entry_points_run_the_towers(entry, tmp_path):
    """`--arch aimv2-tiny` through `predict_directory`, the serving
    predictor, `runner.run` and the runner with `--lora_encoder text` (the
    text tower's block with LoRA), on the CPU: an answer for every image,
    probabilities that sum to 1."""
    import io
    import json

    import numpy as np
    from PIL import Image

    from ttl_tpu_torch import predict as tpredict
    from ttl_tpu_torch import runner as trunner
    from ttl_tpu_torch.data.views import ArrayDataset
    from ttl_tpu_torch.serve import TTLPredictor

    rng = np.random.RandomState(0)
    images = [(rng.rand(70 + 9 * i, 90, 3) * 255).astype(np.uint8)
              for i in range(3)]
    classes = ["forest", "river", "highway"]
    kw = dict(arch="aimv2-tiny", resolution=64, batch_size=8, rank=4,
              compute_dtype="float32", param_dtype="float32", sample_batch=2,
              seed=SEED)
    if entry == "predict":
        for i, arr in enumerate(images):
            Image.fromarray(arr).save(tmp_path / f"img_{i}.png")
        sink = io.StringIO()
        n = tpredict.predict_directory(TTLConfig(**kw, data=str(tmp_path),
                                                 workers=1), classes,
                                       device="cpu", topk=3, out=sink)
        out = [json.loads(line) for line in sink.getvalue().splitlines()]
        assert n == len(out) == 3
    elif entry == "serve":
        out = TTLPredictor(classes, TTLConfig(**kw), device="cpu",
                           warmup=False).predict(images)
        assert len(out) == 3
    else:
        cfg = TTLConfig(**kw, lora_encoder="image" if entry == "runner"
                        else "text")
        arrays = np.stack([np.resize(a, (80, 90, 3)) for a in images])
        res = trunner.run(cfg, device="cpu", datasets={
            "A": ArrayDataset(arrays, np.array([0, 1, 2]))})
        top1, top5 = res["A"]
        assert 0 <= top1 <= 100 and 0 <= top5 <= 100
        return
    for r in out:
        assert r["label"] in classes and r["zero_shot_label"] in classes
        assert abs(sum(t["prob"] for t in r["topk"]) - 1.0) < 1e-3


# ----------------------------------------------------------- refused modes

def test_int8_prefix_model_axis_and_checkpoint_raise(tiny):
    cfg, clip_cfg, params, _, views, _, _ = tiny
    with pytest.raises(ValueError, match="int8"):
        tq.quant_prefix_len(cfg, clip_cfg)
    with pytest.raises(ValueError, match="int8"):
        load_model(ttl_config(prefix_quant="int8"), "cpu")
    with pytest.raises(ValueError, match="model axis"):
        load_model(ttl_config(mesh_shape=(1, 2)), "cpu")
    with pytest.raises(ValueError, match="model axis"):
        check_model_axis(clip_cfg, (2, 2))
    check_model_axis(clip_cfg, (2,))                  # the data axis alone
    check_model_axis(TEST_TINY, (1, 2))               # CLIP splits
    with pytest.raises(ValueError, match="checkpoint_path"):
        load_model(ttl_config(checkpoint_path="model.pt"), "cpu")
    with torch.enable_grad(), pytest.raises(ValueError, match="forward"):
        tclip.vision_prefix(params["vision"],
                            views[0].clone().requires_grad_(True),
                            clip_cfg.vision, upto=2, fold="linear",
                            compute_dtype=torch.float32)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    return torch.device("cuda")


# K1/K2's tensor-core bounds (tests/test_torch_attention.py): the forward
# rounds P to bf16 once against the running max, 2 bf16 steps of the
# output's scale; the backward's f32 factors enter as hi + lo bf16 terms, 4
MMA_FWD_BOUND = 2 * 2.0 ** -8
MMA_BWD_BOUND = 4 * 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,seq_len", [
    (4, 256, 8, 256),      # AIMv2-L/14's heads
    (2, 112, 2, 70),       # two stages, the second mostly padding
    (3, 32, 2, 17),        # a short head: 2 warps, 32-row stages
    (1, 592, 2, 577)])     # many stages
def test_k1_k2_at_head_dim_128(card, b, s, h, seq_len):
    """K1/K2 on the tensor cores at head dim 128 against the plain version
    within the card run's bounds, on the rows below seq_len; the backward
    twice, bit for bit; f32 has no route there."""
    assert tfa.kernel_route(False, torch.bfloat16, s, 128) == "tensor cores"
    assert tfa.kernel_route(True, torch.bfloat16, s, 128) == "tensor cores"
    with pytest.raises(ValueError, match="head dim 128"):
        tfa.kernel_route(False, torch.float32, s, 128)
    g = torch.Generator().manual_seed(s)
    q, k, v, do = (torch.randn(b, s, h * 128, generator=g).to(
        card, torch.bfloat16) for _ in range(4))
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
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.bshd_forward_cuda(q.float(), k.float(), v.float(), h, seq_len)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype", [
    (8 * 256 + 1, 1024, torch.bfloat16), (5 * 77 + 3, 768, torch.bfloat16),
    (999, 256, torch.bfloat16), (513, 1024, torch.float32)],
    ids=["1024", "768", "256", "f32-1024"])
def test_rms_kernels_against_the_plain_version(card, rows, k, dtype):
    """The RMS forward within FWD_BOUND of the plain version (both round the
    same f32 value; the sum of squares in another order), rstd to 1e-5;
    dx within one bf16 step plus 2^-12 of the largest (f32: 1e-5 of it),
    as the centered dx; each launch counted as RMS."""
    x, p, dy = inputs(rows, k, dtype, card, seed=k + 7)
    want = tln.layer_norm_plain(x, p["scale"], None, 1e-5, "rms")
    before = (tln.layer_norm.launches, tln.layer_norm.rms_launches)
    got = taim.rms_norm(x, p, 1e-5)
    _within(got, want, *FWD_BOUND[dtype])
    _, mu, rstd = tln.layer_norm_cuda(x, p["scale"], None, 1e-5, True, "rms")
    x32 = x.float()
    torch.testing.assert_close(rstd, torch.rsqrt(x32.square().mean(-1)
                                                 + 1e-5), rtol=1e-5, atol=0)
    assert not mu.any()
    leaf = x.clone().requires_grad_(True)
    (want_dx,) = torch.autograd.grad(
        tln.layer_norm_plain(leaf, p["scale"], None, 1e-5, "rms"), leaf, dy)
    (dx,) = torch.autograd.grad(taim.rms_norm(leaf, p, 1e-5), leaf, dy)
    rel, floor = (2.0 ** -7, 2.0 ** -12) if dtype == torch.bfloat16 \
        else (0.0, 1e-5)
    _within(dx, want_dx, rel, floor)
    assert (tln.layer_norm.launches - before[0],
            tln.layer_norm.rms_launches - before[1]) == (3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [
    (8 * 64 * 256, 1024, 3072, torch.bfloat16),   # RMSNorm_1 -> qkv
    (8 * 64 * 256, 1024, 5632, torch.bfloat16),   # RMSNorm_2 -> [Wg | Wu]
    (77, 48, 80, torch.bfloat16),                 # short of the tiles
    (300, 256, 384, torch.float32)])
def test_k6_rms_prologue_against_the_plain_version(card, m, k, n, dtype):
    """K6 with the RMS statistics and a zero bias against the plain version
    (rms_norm -> linear with the product summed in f32), as K6's linear
    epilogue is held (tests/test_torch_ln_matmul.py): at bf16 an output may
    round one step the other way, 2 bf16 steps of the largest, in under 1 %
    of the outputs; f32 1e-5 of the scale. Counted as an RMS launch."""
    g = torch.Generator().manual_seed(m + n)
    x = (torch.randn(m, k, generator=g) * 2 + 0.5).to(card, dtype)
    scale = (1 + 0.3 * torch.randn(k, generator=g)).to(card)
    w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(card, dtype)
    before = (tlm.ln_matmul.launches, tlm.ln_matmul.rms_launches)
    got = tlm.ln_matmul(x, scale, None, w, None, 1e-5, epilogue="linear",
                        stats="rms")
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = tlm.ln_matmul_plain(x, scale, None, w, None, 1e-5, "linear",
                                   stats="rms").float()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    torch.cuda.synchronize()
    assert (tlm.ln_matmul.launches - before[0],
            tlm.ln_matmul.rms_launches - before[1]) == (1, 1)
    assert got.dtype == dtype and got.shape == (m, n)
    diff = (got.float() - want).abs()
    rel = 2 * 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    assert diff.max().item() <= rel * max(1.0, want.abs().max().item())
    if dtype == torch.bfloat16:
        assert (diff > 0).float().mean().item() < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("stats", ["centered", "ex2"])
@pytest.mark.parametrize("rows,k", [(8 * 208 + 1, 768), (4 * 592 + 3, 1024),
                                    (2 * 592 + 1, 2730)],
                         ids=["vitb16", "l14", "eva02-ffn"])
def test_centered_and_ex2_codes_as_before(card, rows, k, stats):
    """Beside the RMS code, the centered and ex2 forward and the dx on
    CLIP's and EVA02's widths, bf16, within the bounds of
    tests/test_torch_layer_norm.py, and none counted as RMS."""
    x, p, dy = inputs(rows, k, torch.bfloat16, card, seed=k + 3)
    before = tln.layer_norm.rms_launches
    want = tln.layer_norm_plain(x, p["scale"], p["bias"], 1e-6, stats)
    got = tln.layer_norm(x, p["scale"], p["bias"], 1e-6, stats)
    _within(got, want, *FWD_BOUND[torch.bfloat16])
    leaf = x.clone().requires_grad_(True)
    (want_dx,) = torch.autograd.grad(
        tln.layer_norm_plain(leaf, p["scale"], p["bias"], 1e-6, stats),
        leaf, dy)
    (dx,) = torch.autograd.grad(
        tln.layer_norm(leaf, p["scale"], p["bias"], 1e-6, stats), leaf, dy)
    _within(dx, want_dx, 2.0 ** -7, 2.0 ** -12)
    assert tln.layer_norm.rms_launches == before
