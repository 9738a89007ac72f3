"""The operation and byte counts behind mfu.offline and the rooflines."""
from __future__ import annotations

import pytest

from benchmark.harness import work
from benchmark.harness.manifest import BENCH, load_json

B16 = load_json(BENCH / "configs" / "clip-vit-b16.json")
L14 = load_json(BENCH / "configs" / "clip-vit-l14.json")


def test_vitb16_prefix_is_1_68_tflop():
    # 64 views x 9 layers x (24 S d^2 + 4 S^2 d) at S = 197, d = 768
    assert work.prefix_flops(B16) / 1e12 == pytest.approx(1.675, abs=5e-4)
    assert round(work.prefix_flops(B16) / 1e12, 3) == 1.675   # "1.68"


def test_image_flops():
    layer = 24 * 197 * 768 ** 2 + 4 * 197 ** 2 * 768
    assert work.layer_flops(B16) == layer
    adapted = (64 * 12 * layer + 1.07 * 64 * 3 * layer
               + 64 * 2 * 196 * 768 * 768 + 2 * 3 * layer)
    assert work.image_flops(B16) == pytest.approx(adapted)
    # ViT-L/14: about 11.8 TFLOP an adapted image
    assert work.image_flops(L14) / 1e12 == pytest.approx(11.79, abs=0.01)


def test_attention_bytes_at_a_small_shape():
    call = work.AttentionCall(batch=2, tokens=5, heads=3, head_dim=4)
    elems = 2 * 5 * 3 * 4
    fwd_bytes, bwd_bytes = 4 * elems * 2, 7 * elems * 2
    fwd_flops, bwd_flops = 4 * 2 * 3 * 25 * 4, 8 * 2 * 3 * 25 * 4
    assert call.forward_bound_s(2) == pytest.approx(max(
        fwd_bytes / 3.35e12, fwd_flops / 989e12))
    assert call.backward_bound_s(2) == pytest.approx(max(
        bwd_bytes / 3.35e12, bwd_flops / 989e12))
    # at the main shape K1 is bound by its bytes: 0.185 ms
    main = work.AttentionCall(512, 197, 12, 64)
    assert main.forward_bound_s(2) * 1e3 == pytest.approx(0.18497, abs=1e-4)


def test_attention_calls_of_a_step():
    fwd, bwd = work.attention_calls(B16, 8)
    assert len(fwd) == 18 and len(bwd) == 3
    assert sum(c.batch == 512 for c in fwd) == 12
    fwd, bwd = work.attention_calls(L14, 8)
    assert len(fwd) == 30 and len(bwd) == 3 and fwd[0].tokens == 257
    assert sum(c.batch == 8 for c in fwd) == 6


# Today's counts, pinned exactly: moving them into `work/clip.py` changed
# no number behind mfu.offline, k1_roofline or k2_roofline.
PINNED = {
    "clip-vit-b16": (2862920013004.8, (512, 197, 12, 64)),
    "clip-vit-l14": (11794248909127.68, (512, 257, 16, 64)),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts_are_pinned(name):
    config = load_json(BENCH / "configs" / f"{name}.json")
    flops, (batch, tokens, heads, head_dim) = PINNED[name]
    assert "architecture" not in config           # CLIP by default
    assert work.image_flops(config) == flops
    layers = config["vision"]["num_hidden_layers"]
    fwd, bwd = work.attention_calls(config, 8)
    views = work.AttentionCall(batch, tokens, heads, head_dim)
    clean = views._replace(batch=8)
    assert fwd == [views] * layers + [clean] * 6
    assert bwd == [views] * 3
    assert all(isinstance(c, work.AttentionCall) for c in fwd + bwd)
