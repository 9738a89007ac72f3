"""Smoke run of the PyTorch port (ttl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, side by side), then:

1. prints the card (torch, and nvidia-smi's name and power limit);
2. K1, the bshd attention forward, against its plain PyTorch version at the
   main-path shapes, with max error and median times (CUDA events); bf16
   must take the tensor-core route, f32 the key-tiled FMA one;
3. K2, the bshd attention backward, against autograd through the plain
   version, likewise; a second backward on the same inputs must give the
   same bits;
4. the main path: `ttl_tpu_torch.runner.run` at ViT-B/16 on test set A
   (200 classes) with every other flag at its default, over 16 synthetic
   images of mixed sizes and random weights made from a seed. It checks
   that K1 ran 15 and K2 3 times per batch, that the logits are finite and
   that top-1/top-5 lie in [0, 100]. It then prints the steady-state wall
   samples/s of a longer run (80 images, the runner's own pipeline) and the
   device busy time and top CUDA kernels of one batch (torch.profiler);
5. card against CPU: one sample through the CUDA path and through the
   plain path on the CPU, same weights and view draws: the adapted logits
   at top-1, and the gradient the step hands AdamW at its first update
   within GRAD_BOUND_REL of its largest element (zero-shot: the logits
   within CARD_CPU_BOUND);
6. K1/K2 at the towers' other geometries (ViT-L/14@336px's 592 tokens in
   bf16 and f32, ViT-L/14's 272, ViT-B/32's 64 with 50 true tokens)
   against their plain versions, and the route each takes: bf16 the tensor
   cores at every length, f32 the FMA routes;
7. K5, the int8 linear, against `linear_q_plain` on the card at the main
   path's shapes and zero-shot's [1664, 768] x [768, 768] (bit for bit),
   with the bf16 `linear` it replaces timed beside it; at the main path's
   bf16 shapes the time of each of its three launches and, at fc1 on no
   path, `torch._int_mm` on the same codes;
8. the int8 main path: phase 4 with `--prefix_quant int8` (54 K5, 15 K1
   and 3 K2 launches per batch);
9. zero-shot: `--tta_steps 0 --prefix_quant int8 --ensemble` (72 K5, 12 K1
   and no K2 launches per batch), the whole tower int8;
10. card against CPU for one sample of the int8 main path and one of
   zero-shot (and of zero-shot without int8); the int8 effect on the card,
   int8 logits minus fp logits, must spread over the classes as the CPU's
   does, so a card run that skipped the int8 layers fails;
11. K3, the per_head attention forward and backward over [B, H, S, D],
   against the plain version and autograd through it, at the vision shape
   [512, 12, 197, 64] bf16 and the causal text shape [1600, 8, 32, 64] bf16
   (and one f32 case each), with `scaled_dot_product_attention` on the same
   tensors and mask timed beside it as a yardstick (no path uses it). The
   bf16 shapes must report the tensor-core route and the f32 ones the FMA
   route, and a second backward on the same inputs must give the same bits.
   Then odd geometries on the tensor-core route (one token; 21 tokens
   causal; 37 and 577 tokens; head dims 16 and 32), the 577-token one with
   a score of about 80 late in a row, so that the running max moves;
12. K4, the heads attention, likewise;
13. the K1/K2 yardstick: `scaled_dot_product_attention` forward and backward
   at [512, 208, 768] bf16 with the 197-key mask and at [16, 592, 1024] bf16
   with the 577-key mask;
14. `--lora_encoder text` under TTL_FUSED_ATTENTION=per_head through
   `runner.run`: both towers through K3 (36 forward and 3 backward launches
   per batch, K1/K2/K4/K5 none);
15. `--lora_encoder prompt` (TPT) under TTL_FUSED_ATTENTION=heads: K4, 60
   forward and 12 backward launches per batch (every text layer
   checkpointed), with the run's peak device memory;
16. `deyo_selection=False` (TPT on LoRA) on the default route, a short run:
   18 K1 and 3 K2 launches per batch, then card against CPU for one sample;
17. card against CPU for one sample of phases 14 and 15, the CPU on the
   plain versions under the same route; beside each, as a yardstick held to
   nothing, the same sample through the einsum route on the card;
18. K6, layernorm folded into the linear behind it, against
   `ln_matmul_plain` on the card at the CoCoOp path's shapes
   ([106496, 768] x [768, 768] and x [768, 3072] bf16), the text width, one
   f32 shape and a ragged M with rows of zeros, with `F.layer_norm` followed
   by `F.linear` (a pair of library calls, on no path) and the package's own
   `layer_norm` + `linear` timed beside it, and the achieved TFLOP/s; ptxas
   on its kernels (no spills in the wgmma ones); at fc1 two calls on the
   same inputs must give the same bits;
19. `--cocoop` on the default route through `runner.run`: the frozen vision
   tower over all 12 layers and 64 views through K6 (48 launches per batch)
   and K1 (12), no other kernel;
20. card against CPU for one CoCoOp sample, `logits` and `adapted_logits`;
21. `--cocoop --load FILE` with a CoCoOp checkpoint the script writes itself
   (a ctx and a meta-net from a seeded generator): one batch with it and one
   without must give different logits;
22. `--filter_plpd 1 --plpd_threshold 0` (PLPD, patch counterfactual;
   PLPD_FLAGS) through `runner.run`:
   the main path plus the whole vision tower once more, without gradient,
   over every view's counterfactual (27 K1 and 3 K2 launches per batch, no
   other kernel), timed as phase 4; then card against CPU for one sample
   (`expect_adapted` within GRAD_BOUND_REL["PLPD"]), with the views the
   filter kept on each side; then 16 images with `--prefix_quant int8`
   too: the counterfactual's prefix through K5 as well (27 K1, 3 K2 and
   108 K5 launches per batch);
23. `--aug_list` over the 9 ops of `ops/augmix.py::DEFAULT_AUG_LIST`
   through `runner.run` (15 K1 and 3 K2 launches per batch), timed as phase
   4, the view
   maker's device ms per batch with and without AugMix, and one sample's
   AugMix views on the card against the CPU's in f32: the share of values
   that differ by more than 1/255 (a threshold op stepped the other way)
   within AUGMIX_STEP_SHARE, that by more than 1e-4 within
   AUGMIX_DIFF_SHARE, and the largest difference below 1/255 printed;
24. `-a RN50 --lora_encoder prompt` (TPT on the ResNet tower, RN50's
   published widths) under TTL_FUSED_ATTENTION=heads through `runner.run`:
   the vision tower on cuDNN convolutions, the text tower through K4 (48
   forward and 12 backward launches per batch, no other kernel), timed as
   phase 4; then card against CPU for one sample (`expect_adapted` within
   GRAD_BOUND_REL["RN50 prompt tuning"]);
25. `-a RN50 --tta_steps 0` (zero-shot) on the default route: no kernel
   launch, timed as phase 4; then card against CPU for one sample within
   CARD_CPU_BOUND;
26. `--checkpoint_path`: the script writes two seeded synthetic checkpoints
   at full width in fp16 into a temporary directory under the build
   directory, an OpenAI-layout RN50 `.pt` and an HF-layout ViT-B/16 `.pt`,
   and runs one batch of each through `runner.run` (RN50 TPT under heads:
   K4 48/12; ViT-B/16's main path: K1 15, K2 3); three loaded leaves must
   equal the file's tensors after the layout change; the loaded params are
   saved with `models.convert.save_pytree`, and one batch from that `.npz`
   must give the same bits as from the file;
27. batch prediction as a user runs it, `python -m ttl_tpu_torch.predict
   DIR --test_sets I --topk 1000` through its `main`, over 24 images of
   mixed sizes (JPEG and PNG) written into a temporary directory under the
   build directory: one JSON line an image, its label its top class, the
   1000 probabilities finite and summing to 1; 18 K1 (the main path's 15
   and 3 for the zero-shot aux pass) and 3 K2 launches per batch; at
   `--tta_steps 0` 12 K1 and every label the zero-shot one; with
   `--prefix_quant int8` 54 K5 more; then 80 images timed as phase 4 (at
   the default `--topk 5` and at 1000) and one batch under torch.profiler;
28. card against CPU for one sample through `serve.TTLPredictor`'s fused
   step (`zero_shot_aux=True`), phase 5's sample: the adapted logits at
   top-1, the first update's gradient within GRAD_BOUND_REL["main path"],
   and the aux pass's zero-shot logits within CARD_CPU_BOUND;
29. the HTTP server as users start it, `python -m ttl_tpu_torch.serve
   --test_sets I --sample_batch 4 --max_queue 64 --port P`, in a process of
   its own: the seconds to its READY line and to the first answer; 16 JPEG
   POSTs and one malformed body at once (16 x 200, 1 x 400, /metrics
   counting them, none shed); one image alone and inside the burst with the
   same answer; SIGTERM, and the server drains and exits 0;
30. `--test_sets bongard` through `runner.run` over 4 synthetic episodes
   (6 + 6 support images and 2 queries each, written under the build
   directory): adapted, 12 K1 an episode for the support encoder and 15 K1
   / 3 K2 for the queries' step, twice with the same bits; zero-shot, 24
   K1 an episode; `-a RN50 --tta_steps 0`, no launch; then the adapted
   protocol timed and profiled.

Every kernel's line also carries `bound_ms`, the least time the card could
take for the call (the larger of its bytes over 3.35 TB/s and its operations
over the peak rate of their type), and `library_ms`, the time of the one
PyTorch call that computes the same function, where there is one.

Any failed phase raises, and the script exits non-zero without its result
line. Without CUDA it exits non-zero at once. The second-to-last lines are a
JSON object of kernel results and the card's nvidia-smi line; the last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

SEED = 0
HEADS, SEQ, SEQ_PAD, WIDTH = 12, 197, 208, 768
# K1 vs plain: both round P to the input dtype and accumulate in f32; the
# tensor cores sum in another order, so a bf16 output may round one ulp
# (2^-8 relative) the other way: bound 2 ulps of the output's scale for
# bf16, 1e-5 for f32.
FWD_BOUND = {torch.bfloat16: 2 * 2.0 ** -8, torch.float32: 1e-5}
# K2 vs autograd through the plain version: the kernel keeps P and every
# product in f32, plain autograd rounds its bf16 intermediates; bound at
# 4 bf16 ulps of the largest gradient (2^-8 relative each); at f32, sums in
# another order, 1e-4 of the largest gradient.
BWD_BOUND_REL = {torch.bfloat16: 4 * 2.0 ** -8, torch.float32: 1e-4}
# K1/K2 at the towers' other geometries: (batch, padded tokens, true
# tokens, heads, width, dtype): ViT-L/14@336px, ViT-L/14, ViT-B/32
OTHER_FWD = [(16, 592, 577, 16, 1024, torch.bfloat16),
             (16, 592, 577, 16, 1024, torch.float32),
             (64, 272, 257, 16, 1024, torch.bfloat16),
             (512, 64, 50, 12, 768, torch.bfloat16)]
OTHER_BWD = OTHER_FWD + [(16, 272, 257, 16, 1024, torch.float32)]
# K5 at the main path's shapes, T = 512 views x 208 tokens, and at
# zero-shot's q, k, v and o, T = 8 center views x 208: (T, K, N, dtype)
K5_ROWS = 512 * SEQ_PAD
K5_FC1 = (K5_ROWS, 768, 3072, torch.bfloat16)
K5_SHAPES = [(K5_ROWS, 768, 768, torch.bfloat16), K5_FC1,
             (K5_ROWS, 3072, 768, torch.bfloat16),
             (K5_ROWS, 768, 768, torch.float32),
             (8 * SEQ_PAD, 768, 768, torch.bfloat16)]
# card (bf16, kernels, cuBLAS) against CPU (bf16, plain version): both round
# every activation to bf16 but accumulate in different orders through 12
# layers. Logits are 100 x a cosine; with random weights |logits| < 2, where
# one bf16 ulp is 2^-7 = 0.0078, and the bound is about 6 such ulps. It holds
# where no AdamW step comes before the logits: zero-shot and CoCoOp's
# `logits`.
CARD_CPU_BOUND = 0.05
# Where one does, AdamW's first update is lr * sign(g) for every element of
# the trainable state, so an element whose gradient lies below the bf16
# noise moves the other way in any two correct runs, and the logits after it
# differ by as much as 0.099 between the card's einsum route and the CPU
# (PERF.md). Those paths compare what the port decides instead: the
# gradient that step hands AdamW (LoRA A and B, or the ctx), card against
# CPU, as max |difference| over the gradient's largest element, and the
# logits at top-1. Each bound is twice the largest difference that
# tools/torch_card_cpu_noise.py measured over image seeds 1-8, on the
# kernels before K1/K2 took the tensor-core bodies and on the einsum route,
# rounded up to a power of two (H100 80GB HBM3, 700 W; PERF.md). The
# vision-LoRA window sees 3 layers of bf16 noise; the text tower, 12, and
# the TPT objective a selection of views that near ties can flip.
GRAD_BOUND_REL = {
    "main path": 2.0 ** -8,        # largest 1.62e-3 (einsum route)
    "int8 main path": 2.0 ** -7,   # 3.76e-3 (kernel route)
    "text-LoRA": 2.0 ** -4,        # 2.96e-2 (kernel route)
    "prompt tuning": 2.0 ** -3,    # 3.85e-2 (einsum route)
    "TPT on LoRA": 2.0 ** -3,      # 4.60e-2 (einsum route)
    "CoCoOp": 2.0 ** -3,           # 6.07e-2 (einsum route)
    "PLPD": 2.0 ** -6,             # 6.00e-3 (kernel route; 4 of 64
                                   # views kept on one side only)
    "RN50 prompt tuning": 2.0 ** -2,   # 9.13e-2 (einsum route; kernel
                                       # route 7.51e-2): the bf16 ResNet
                                       # tower's features on cuDNN against
                                       # the CPU's convolutions
}
# PLPD's flags in phase 22. With random weights the top class of a view
# holds a few percent of the mass over 200 classes, so the default
# threshold of 0.2 would drop every view and the step would update nothing;
# at 0 a view is kept where its counterfactual lowers its top class.
PLPD_FLAGS = ("--filter_plpd", "1", "--plpd_threshold", "0")
# AugMix views, card against CPU in f32 (values in [0, 1]): posterize,
# solarize and equalize step at thresholds, so a value an f32 rounding away
# from one lands a step away on one side, scaled by the mix's weights. The
# shares of values that differ by more than 1/255 and by more than 1e-4 are
# bounded at twice the largest that tools/torch_card_cpu_noise.py --views
# measured over image seeds 1-8, rounded up to a power of two (H100 80GB
# HBM3, 700 W; PERF.md). The largest difference below 1/255 is
# printed (3.87e-3 at most over those seeds).
AUGMIX_STEP_SHARE = 2.0 ** -18   # largest 1.25e-6
AUGMIX_DIFF_SHARE = 2.0 ** -13   # largest 4.91e-5
# With the int8 prefix, those bf16 differences also move activations across
# .5 boundaries of the int8 grid: a share of the codes differs by one step
# between card and CPU, noise of the same kind as the int8 rounding itself.
# The bound adds the CPU's whole int8 effect on this sample, max |int8 - fp|
# logits, which a share of flipped codes cannot exceed.
# That bound cannot tell an int8 card run from an fp one: the effect is of
# the size of the bf16 noise. Its spread over the classes can. The effect
# on the card, card_q - card_fp, and on the CPU, cpu_q - cpu_fp, come from
# the same rounding of the same weights and activations, so their standard
# deviations over the 200 classes agree (ratios 0.95 to 1.07 on both paths,
# in bf16 and f32, on an H100 80GB HBM3). Their means, a shift common to
# all logits, and their directions are not stable: flipped codes spread
# through the layers above them. A card run that skipped the int8 layers
# has no effect at all (card_q == card_fp).
EFFECT_SPREAD = (0.5, 2.0)
# K3/K4 at the shapes the text-side paths give them: the vision tower's 512
# views and the text tower's 8 samples x 200 class prompts of 32 tokens
# (test set A's table after EOT truncation): (B, H, S, D, causal, dtype)
BHSD_SHAPES = [(512, 12, 197, 64, False, torch.bfloat16),
               (1600, 8, 32, 64, True, torch.bfloat16),
               (64, 12, 197, 64, False, torch.float32),
               (1600, 8, 32, 64, True, torch.float32)]
# Odd geometries for the tensor-core route of K3/K4, all bf16: one token, a
# ragged causal head, a ragged tile, ViT-L/14@336px's 577 tokens (ten key
# stages), and the head dims 16 and 32: (B, H, S, D, causal)
BHSD_ODD = [(3, 4, 1, 64, False), (3, 4, 21, 64, True), (2, 4, 37, 64, False),
            (1, 16, 577, 64, False), (2, 4, 70, 16, True),
            (2, 4, 70, 32, False)]
# K6 at the CoCoOp path's shapes (8 samples x 64 views x 208 tokens), the text
# tower's width (1600 prompts x 32 tokens), one f32 shape, and a ragged M
# (prime, so a multiple of no row tile) with rows of zeros: (M, K, N, dtype)
K6_ROWS = 512 * SEQ_PAD
K6_FC1 = (K6_ROWS, 768, 3072, torch.bfloat16)
K6_SHAPES = [(K6_ROWS, 768, 768, torch.bfloat16), K6_FC1,
             (1600 * 32, 512, 2048, torch.bfloat16),
             (8192, 768, 768, torch.float32),
             (10007, 768, 3072, torch.bfloat16)]
# K6 vs plain. bf16: both round the normalised row and the output once, but
# the statistics and the product sum in another order, so a normalised value
# or an output may round the other way: one bf16 step of the output, which
# at the top of its range is at most 2^-7 of the largest output. f32: the
# order of the sums only, 1e-5 of the output's scale.
K6_BOUND = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
# The CoCoOp sample of the card-against-CPU run. With random weights the
# features barely depend on the image and the two best of the 200 classes
# lie close: of the images made from seeds 1 to 12, this one keeps them
# furthest apart on the card (0.046 for `logits`, 0.094 for
# `adapted_logits`; seed 1: 0.0015), beyond the bf16 noise between card and
# CPU, so that agreement at top-1 is a statement about the port.
COCOOP_IMAGE_SEED = SEED + 3
# the card's published peaks (H100 SXM, dense, at 700 W): bytes/s of HBM and
# operations/s by operand type
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def bound(n_bytes: float, n_ops: float, dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES
    by_ops = 1e3 * n_ops / PEAK_OPS[dtype]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attention_bound(n_tensors: int, flops_per_pair: int, b, h, s, d, dtype,
                    causal: bool = False) -> dict:
    """Attention over B*H heads of S tokens: `n_tensors` tensors of B*H*S*D
    elements move once (4 forward: q, k, v, o; 7 backward: q, k, v, do, dq,
    dk, dv); each kept (query, key) pair costs `flops_per_pair` * D
    operations (4 forward: two products; 10 backward: five)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return bound(n_tensors * b * h * s * d * itemsize,
                 flops_per_pair * b * h * pairs * d, dtype)


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(b: int, dtype, n: int, seed: int, s: int = SEQ_PAD,
           width: int = WIDTH):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, width, generator=g).to("cuda", dtype)
            for _ in range(n)]


def check_forward(fa, b, s, seq_len, heads, width, dtype, seed) -> dict:
    q, k, v = inputs(b, dtype, 3, seed, s, width)
    out = fa.bshd_forward_cuda(q, k, v, heads, seq_len)
    ref = fa.attention_bshd_plain(q, k, v, heads, seq_len)
    torch.cuda.synchronize()
    err = (out.float() - ref.float())[:, :seq_len].abs().max().item()
    bound = FWD_BOUND[dtype] * max(1.0, ref.float().abs().max().item())
    ms = median_ms(lambda: fa.bshd_forward_cuda(q, k, v, heads, seq_len))
    plain_ms = median_ms(
        lambda: fa.attention_bshd_plain(q, k, v, heads, seq_len))
    route = fa.kernel_route(False, dtype, s, width // heads)
    log(f"K1 [{b}, {s}, {width}] {dtype} ({route}): "
        f"max_abs_err {err:.3e} (bound {bound:.3e}), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    if not err <= bound:
        raise AssertionError(f"K1 disagrees with its plain version: {err}"
                             f" > {bound}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **attention_bound(4, 4, b, heads, s, width // heads, dtype)}


def check_backward(fa, b, s, seq_len, heads, width, dtype, seed) -> dict:
    q, k, v, do = inputs(b, dtype, 4, seed, s, width)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.attention_bshd_plain(*leaves, heads, seq_len)
    want = torch.autograd.grad(out, leaves, do, retain_graph=True)
    got = fa.bshd_backward_cuda(q, k, v, do, heads, seq_len)
    again = fa.bshd_backward_cuda(q, k, v, do, heads, seq_len)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        if not torch.isfinite(g).all():
            raise AssertionError(f"K2 {name} is not finite")
        if not torch.equal(g, g2):
            raise AssertionError(f"K2 {name} differs between two runs")
        err = (g.float() - w.float())[:, :seq_len].abs().max().item()
        bound = BWD_BOUND_REL[dtype] * w.float().abs().max().item()
        log(f"K2 {name}: max_abs_err {err:.3e} (bound {bound:.3e})")
        if not err <= bound:
            raise AssertionError(f"K2 {name} disagrees with autograd through "
                                 f"the plain version: {err} > {bound}")
        worst = max(worst, err)
    ms = median_ms(lambda: fa.bshd_backward_cuda(q, k, v, do, heads, seq_len))
    plain_ms = median_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    route = fa.kernel_route(True, dtype, s, width // heads)
    log(f"K2 [{b}, {s}, {width}] {dtype} ({route}): two runs bit for bit, "
        f"kernel {ms:.4f} ms, plain (autograd backward) {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **attention_bound(7, 10, b, heads, s, width // heads, dtype)}


def sdpa_ms(q, k, v, do, mask=None, causal: bool = False) -> tuple:
    """(forward ms, backward ms) of `scaled_dot_product_attention` over
    [B, H, S, D] tensors: the library call that computes what K1-K4
    compute. A yardstick only: no path of the package calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = median_ms(lambda: sdpa(q, k, v, attn_mask=mask, is_causal=causal))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, attn_mask=mask, is_causal=causal)
    bwd = median_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True))
    return fwd, bwd


def bshd_yardstick(b, s, seq_len, heads, width) -> tuple:
    """(forward ms, backward ms) of `scaled_dot_product_attention` at a
    K1/K2 shape in bf16, heads as strided views of the [B, S, H*D] tensors,
    keys past seq_len masked."""
    q, k, v, do = (t.unflatten(-1, (heads, -1)).transpose(1, 2)
                   for t in inputs(b, torch.bfloat16, 4, 13, s, width))
    mask = (torch.arange(s, device="cuda") < seq_len)[None, None, None]
    fwd, bwd = sdpa_ms(q, k, v, do, mask=mask)
    log(f"scaled_dot_product_attention [{b}, {s}, {width}] bf16, "
        f"{seq_len}-key mask: forward {fwd:.4f} ms, backward {bwd:.4f} ms")
    return fwd, bwd


def phase_bshd_yardstick(other: dict) -> tuple:
    """The yardstick at K1/K2's main-path shape (returned) and at
    ViT-L/14@336px's, whose bf16 entries of `other` it completes."""
    b, s, seq_len, heads, width, _ = OTHER_FWD[0]
    fwd, bwd = bshd_yardstick(b, s, seq_len, heads, width)
    other[("fwd", s, torch.bfloat16)]["library_ms"] = fwd
    other[("bwd", s, torch.bfloat16)]["library_ms"] = bwd
    return bshd_yardstick(512, SEQ_PAD, SEQ, HEADS, WIDTH)


def bhsd_inputs(b, h, s, d, dtype, large_score: bool = False):
    """q, k, v, do for K3/K4 from a seeded generator. With `large_score`,
    key s - 77 is ten times query row 5, so that row's score there is about
    10 * 64 / 8 = 80 and every row's is large, late in the row."""
    g = torch.Generator().manual_seed(SEED + s)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g) for _ in range(4))
    if large_score:
        k[:, :, s - 77] = 10.0 * q[:, :, 5]
    return [t.to("cuda", dtype) for t in (q, k, v, do)]


def check_bhsd(fa, route: str, label: str, shape: str, q, k, v, do,
               causal: bool) -> tuple:
    """One K3/K4 geometry against the plain version and autograd through
    it, within FWD_BOUND and BWD_BOUND_REL; the backward run twice must give
    the same bits. Returns (forward error, worst backward error, the plain
    output and its leaves for timing)."""
    forward = getattr(fa, f"{route}_forward_cuda")
    backward = getattr(fa, f"{route}_backward_cuda")
    dtype = q.dtype
    want_route = ("tensor cores" if dtype == torch.bfloat16
                  else "key-tiled FMA")
    got_route = fa.bhsd_kernel_route(dtype, q.shape[-1])
    if got_route != want_route:
        raise AssertionError(f"{label} at {shape}: the {got_route} route, "
                             f"not {want_route}")
    out = forward(q, k, v, causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.attention_bhsd_plain(*leaves, causal)
    want = torch.autograd.grad(ref, leaves, do, retain_graph=True)
    got = backward(q, k, v, do, causal)
    again = backward(q, k, v, do, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    limit = FWD_BOUND[dtype] * max(1.0, ref.float().abs().max().item())
    if not torch.isfinite(out).all() or not err <= limit:
        raise AssertionError(f"{label} forward at {shape} disagrees with "
                             f"its plain version: {err} > {limit}")
    worst = 0.0
    for name, gk, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        e = (gk.float() - w.float()).abs().max().item()
        lim = BWD_BOUND_REL[dtype] * w.float().abs().max().item()
        if not torch.isfinite(gk).all() or not e <= lim:
            raise AssertionError(f"{label} backward {name} at {shape} "
                                 f"disagrees with autograd through the "
                                 f"plain version: {e} > {lim}")
        if not torch.equal(gk, g2):
            raise AssertionError(f"{label} backward {name} at {shape} "
                                 f"differs between two runs")
        worst = max(worst, e)
    return err, worst, ref, leaves


def phase_bhsd(fa, route: str, label: str) -> dict:
    """K3 (`route` per_head) or K4 (heads), forward and backward, against
    the plain version and autograd through it at BHSD_SHAPES, then at
    BHSD_ODD. Returns the forward and the backward results at each of
    BHSD_SHAPES."""
    forward = getattr(fa, f"{route}_forward_cuda")
    backward = getattr(fa, f"{route}_backward_cuda")
    results = {}
    for b, h, s, d, causal, dtype in BHSD_SHAPES:
        q, k, v, do = bhsd_inputs(b, h, s, d, dtype)
        shape = f"[{b}, {h}, {s}, {d}] {dtype}, causal={causal}"
        err, worst, ref, leaves = check_bhsd(fa, route, label, shape, q, k, v,
                                             do, causal)
        lib_fwd, lib_bwd = sdpa_ms(q, k, v, do, causal=causal)
        fwd = {"max_abs_err": err,
               "ms": median_ms(lambda: forward(q, k, v, causal)),
               "plain_ms": median_ms(
                   lambda: fa.attention_bhsd_plain(q, k, v, causal)),
               **attention_bound(4, 4, b, h, s, d, dtype, causal),
               "library_ms": lib_fwd}
        bwd = {"max_abs_err": worst,
               "ms": median_ms(lambda: backward(q, k, v, do, causal)),
               "plain_ms": median_ms(lambda: torch.autograd.grad(
                   ref, leaves, do, retain_graph=True)),
               **attention_bound(7, 10, b, h, s, d, dtype, causal),
               "library_ms": lib_bwd}
        for kind, r in (("forward", fwd), ("backward", bwd)):
            log(f"{label} {kind} {shape} "
                f"({fa.bhsd_kernel_route(dtype, d)}): max_abs_err "
                f"{r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), scaled_dot_product_attention "
                f"{r['library_ms']:.4f} ms")
        results[shape] = {"fwd": fwd, "bwd": bwd}
        del q, k, v, do, ref, leaves
    for b, h, s, d, causal in BHSD_ODD:
        q, k, v, do = bhsd_inputs(b, h, s, d, torch.bfloat16,
                                  large_score=s == 577)
        shape = f"[{b}, {h}, {s}, {d}] bf16, causal={causal}"
        err, worst, ref, _ = check_bhsd(fa, route, label, shape, q, k, v, do,
                                        causal)
        log(f"{label} {shape} (tensor cores): forward max_abs_err {err:.3e},"
            f" backward {worst:.3e}, two backward runs bit for bit, largest "
            f"|score| {score_range(q, k):.1f}")
    return results


def score_range(q, k) -> float:
    d = q.shape[-1]
    return (torch.matmul(q.float(), k.float().transpose(-1, -2)).abs().max()
            / d ** 0.5).item()


def phase_forward(fa) -> dict:
    results = {}
    for b, dtype in [(512, torch.bfloat16), (8, torch.bfloat16),
                     (8, torch.float32)]:
        expect_route(fa, False, dtype, SEQ_PAD, WIDTH // HEADS)
        results[(b, dtype)] = check_forward(fa, b, SEQ_PAD, SEQ, HEADS, WIDTH,
                                            dtype, seed=b)
    return results[(512, torch.bfloat16)]


def phase_backward(fa) -> dict:
    expect_route(fa, True, torch.bfloat16, SEQ_PAD, WIDTH // HEADS)
    return check_backward(fa, 512, SEQ_PAD, SEQ, HEADS, WIDTH,
                          torch.bfloat16, seed=7)


def expect_route(fa, backward: bool, dtype, s: int, d: int):
    """K1/K2's route rule: bf16 on the tensor cores at every length; f32
    on the FMA routes, the backward on the whole-head kernel up to
    ViT-B/16's 208 keys and key-tiled past them."""
    if dtype == torch.bfloat16:
        want = "tensor cores"
    elif backward and s <= SEQ_PAD:
        want = "whole-head FMA"
    else:
        want = "key-tiled FMA"
    route = fa.kernel_route(backward, dtype, s, d)
    if route != want:
        raise AssertionError(f"{'K2' if backward else 'K1'} at {s} keys, "
                             f"{dtype}: the {route} route, not {want}")


def phase_other_geometries(fa) -> dict:
    """K1/K2 at OTHER_FWD / OTHER_BWD, each on the route the rule names."""
    out = {}
    for b, s, seq_len, heads, width, dtype in OTHER_FWD:
        expect_route(fa, False, dtype, s, width // heads)
        out[("fwd", s, dtype)] = check_forward(fa, b, s, seq_len, heads,
                                               width, dtype, seed=s)
    for b, s, seq_len, heads, width, dtype in OTHER_BWD:
        expect_route(fa, True, dtype, s, width // heads)
        out[("bwd", s, dtype)] = check_backward(fa, b, s, seq_len, heads,
                                                width, dtype, seed=s + 1)
    return out


def k5_launch_ms(tq, x, pq, reps: int = 5, tries: int = 3):
    """Device ms of each of K5's launches within one call at x's shape,
    averaged over the launches of `reps` calls (torch.profiler): (Q)
    `quant_rows`, (W) `transpose_w`, (G) `gemm`. A profiler run in a
    process that has run others may record no kernel at all: it is run
    again, and after `tries` empty runs the result is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tq.linear_q(x, pq)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                tq.linear_q(x, pq)
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            found = re.search(r"k5_(\w+?)_kernel", e.key)
            if e.device_type == DeviceType.CUDA and found:
                # per launch the profiler kept (it may miss a call's)
                out[found.group(1)] = (e.self_device_time_total / 1e3
                                       / e.count)
        if set(out) == {"quant_rows", "transpose_w", "gemm"}:
            return out
    return None


def phase_k5(tq) -> dict:
    """K5 against linear_q_plain on the card (bit for bit) and the bf16
    linear it replaces, at K5_SHAPES; at the main path's bf16 shapes the
    time of each of its launches, and at fc1 `torch._int_mm` (cuBLASLt's
    int8 product, int32 out, on no path) on the same codes and K-major
    weight beside (G)."""
    from ttl_tpu_torch.models.clip import linear
    g = torch.Generator().manual_seed(SEED + 5)
    results = {}
    for t, k, n, dtype in K5_SHAPES:
        x = torch.randn(t, k, generator=g).to("cuda", dtype)
        p = {"w": (torch.randn(k, n, generator=g) * 0.02).cuda(),
             "b": (torch.randn(n, generator=g) * 0.02).cuda()}
        pq = tq.quantize_linear(p)
        got = tq.linear_q(x, pq)
        want = tq.linear_q_plain(x, pq)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = median_ms(lambda: tq.linear_q(x, pq))
        plain_ms = median_ms(lambda: tq.linear_q_plain(x, pq), reps=5)
        pf = {name: w.to(dtype) for name, w in p.items()}
        linear_ms = median_ms(lambda: linear(x, pf))
        log(f"K5 [{t}, {k}] x [{k}, {n}] {dtype}: max_abs_err {err} "
            f"(bound 0), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{dtype} linear {linear_ms:.4f} ms")
        if err != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"K5 differs from linear_q_plain: {err}")
        itemsize = x.element_size()
        results[(t, k, n, dtype)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "linear_ms": linear_ms,
            # x read, wq (int8) with its f32 column scales and bias read,
            # y written; 2*T*K*N int8 operations
            **bound(t * (k + n) * itemsize + k * n + 8 * n,
                    2 * t * k * n, torch.int8)}
        if dtype == torch.bfloat16 and t == K5_ROWS:
            launch = k5_launch_ms(tq, x, pq)
            log(f"K5 [{t}, {k}] x [{k}, {n}] per launch (torch.profiler): "
                + ("not measured (the profiler recorded no kernel)"
                   if launch is None else
                   f"(Q) quant_rows {launch['quant_rows']:.4f} ms, (W) "
                   f"transpose_w {launch['transpose_w']:.4f} ms ("
                   f"{100 * launch['transpose_w'] / sum(launch.values()):.2f}"
                   f"% of the three), (G) gemm {launch['gemm']:.4f} ms ("
                   f"{2e-9 * t * k * n / launch['gemm']:.1f} TOP/s)"))
            results[(t, k, n, dtype)]["launch_ms"] = launch
        if (t, k, n, dtype) == K5_FC1:
            codes = torch.clamp(torch.round((x / tq._row_scale(x)).float()),
                                -127, 127).to(torch.int8)
            wt = pq["wq"].t().contiguous()
            int_mm_ms = median_ms(lambda: torch._int_mm(codes, wt.t()))
            log(f"K5 at fc1: torch._int_mm on the same codes and K-major "
                f"weight {int_mm_ms:.4f} ms "
                f"({2e-9 * t * k * n / int_mm_ms:.1f} TOP/s, int32 out, on "
                "no path)")
            results[(t, k, n, dtype)]["int_mm_ms"] = int_mm_ms
            del codes, wt
        del x, got, want
    return results


def phase_k6(tlm) -> dict:
    """K6 against ln_matmul_plain on the card at K6_SHAPES, with the pair of
    library calls that computes the same function (F.layer_norm, F.linear;
    w transposed to F.linear's layout outside the timing) and the package's
    own layer_norm + linear, the pair K6 stands in for, timed beside it;
    ptxas's registers, shared memory and spills of its kernels first (the
    wgmma kernels may spill nothing), the achieved rate at every shape, and
    at fc1 a second call on the same inputs, which must give the same
    bits."""
    from ttl_tpu_torch.models.clip import layer_norm, linear
    from ttl_tpu_torch.ops import _build
    F = torch.nn.functional
    log("ptxas on K6's kernels (ln_matmul.cu):")
    for key, used in sorted(_build.kernel_resources("ln_matmul").items()):
        log(f"  {key.split(': ', 1)[1]}: {used}")
        if "wgmma" in key and not re.search(
                r"\b0 bytes spill stores, 0 bytes spill loads", used):
            raise AssertionError(f"K6's {key} spills: {used}")
    g = torch.Generator().manual_seed(SEED + 6)
    results = {}
    for m, k, n, dtype in K6_SHAPES:
        x = torch.randn(m, k, generator=g) * 2.0 + 0.5
        ragged = m % 32 != 0
        if ragged:
            x[[0, m // 2, m - 1]] = 0.0
        x = x.to("cuda", dtype)
        scale = (1.0 + 0.1 * torch.randn(k, generator=g)).cuda()
        bias = (0.1 * torch.randn(k, generator=g)).cuda()
        w = (torch.randn(k, n, generator=g) * 0.05).to("cuda", dtype)
        b = (0.1 * torch.randn(n, generator=g)).cuda()
        before = tlm.ln_matmul.launches
        got = tlm.ln_matmul(x, scale, bias, w, b, 1e-5)
        want = tlm.ln_matmul_plain(x, scale, bias, w, b, 1e-5)
        torch.cuda.synchronize()
        shape = f"[{m}, {k}] x [{k}, {n}] {dtype}"
        if tlm.ln_matmul.launches != before + 1:
            raise AssertionError(f"K6 at {shape}: no launch was counted")
        err = (got.float() - want.float()).abs().max().item()
        limit = K6_BOUND[dtype] * max(1.0, want.float().abs().max().item())
        if not torch.isfinite(got).all() or not err <= limit:
            raise AssertionError(f"K6 at {shape} disagrees with its plain "
                                 f"version: {err} > {limit}")
        if (m, k, n, dtype) == K6_FC1:
            again = tlm.ln_matmul(x, scale, bias, w, b, 1e-5)
            if not torch.equal(got, again):
                raise AssertionError(f"K6 at {shape}: two calls on the same "
                                     "inputs gave different bits")
            log(f"K6 {shape}: a second call gave the same bits")
            del again
        ms = median_ms(lambda: tlm.ln_matmul(x, scale, bias, w, b, 1e-5))
        plain_ms = median_ms(
            lambda: tlm.ln_matmul_plain(x, scale, bias, w, b, 1e-5), reps=5)
        wt, sc, bi, bb = (w.t().contiguous(), scale.to(dtype),
                          bias.to(dtype), b.to(dtype))
        library_ms = median_ms(lambda: F.linear(
            F.layer_norm(x, (k,), sc, bi, 1e-5), wt, bb))
        ln_p, lin_p = {"scale": scale, "bias": bias}, {"w": w, "b": bb}
        pair_ms = median_ms(lambda: linear(layer_norm(x, ln_p, 1e-5), lin_p))
        itemsize = x.element_size()
        results[(m, k, n, dtype)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            # x and w read, the three f32 vectors read, out written once;
            # 2*M*K*N operations of the product's type
            **bound((m * k + k * n + m * n) * itemsize + 4 * (2 * k + n),
                    2 * m * k * n, dtype),
            "library_ms": library_ms, "port_pair_ms": pair_ms,
            "tflops": 2e-9 * m * k * n / ms}
        r = results[(m, k, n, dtype)]
        log(f"K6 {shape}{' (rows of zeros)' if ragged else ''}: max_abs_err "
            f"{err:.3e} (bound {limit:.3e}), kernel {ms:.4f} ms "
            f"({r['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; kernel "
            f"{ms / r['bound_ms']:.2f}x of it), F.layer_norm + F.linear "
            f"{library_ms:.4f} ms, the package's layer_norm + linear "
            f"{pair_ms:.4f} ms")
        del x, w, wt, got, want
    return results


class SyntheticImages:
    """In-memory dataset of uint8 [H, W, 3] images of several sizes, with the
    interface of the package's ArrayDataset that the loader reads."""

    SIZES = [(224, 224), (375, 500), (480, 320), (160, 200)]

    def __init__(self, n: int):
        rng = np.random.default_rng(SEED)
        self.images = [rng.integers(0, 256, self.SIZES[i % len(self.SIZES)]
                                    + (3,), dtype=np.uint8)
                       for i in range(n)]
        self.labels = rng.integers(0, 200, n)
        self.max_image_dim = max(max(im.shape[:2]) for im in self.images)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], int(self.labels[idx])


def config(*flags):
    """The configuration of `python -m ttl_tpu_torch DATA --test_sets A`
    with `flags`: ViT-B/16, every other TTL flag at its default."""
    from ttl_tpu_torch.cli import build_parser, config_from_args
    return config_from_args(build_parser().parse_args(
        ["synthetic", "--test_sets", "A", "--seed", str(SEED), *flags]))


def profiled(fn, *args):
    """fn(*args) under torch.profiler, waited for: (its result, the device
    busy ms, the table of the top CUDA kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn(*args)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    # device events only: a CPU op's device time repeats its kernels'
    busy_ms = sum(e.self_device_time_total for e in avg
                  if e.device_type == DeviceType.CUDA) / 1e3
    return res, busy_ms, avg.table(sort_by="self_cuda_time_total",
                                   row_limit=15, max_name_column_width=60)


class StepProbe:
    """Stands in for the runner's step factory (make_fused_ttl_fn,
    make_fused_tpt_fn, make_fused_cocoop_fn or make_fused_zeroshot_fn). It wraps the step, records
    the host clock as each step is dispatched and keeps each batch's logits
    for `check` after the run: checking them inside would wait for the device
    and empty the runner's pipeline. With `profile`, each step runs under
    torch.profiler and is waited for."""

    def __init__(self, make_step, profile: bool = False):
        self.make_step, self.profile = make_step, profile
        self.starts, self.logits = [], []
        self.table = self.busy_ms = None

    def __call__(self, clip_cfg, cfg, **kw):
        step_fn = self.make_step(clip_cfg, cfg, **kw)

        def step(*args):
            self.starts.append(time.perf_counter())
            if self.profile:
                res = self._profiled(step_fn, args)
            else:
                res = step_fn(*args)
            # AdaptResult or CoCoOpResult, (AdaptResult, ctx) from prompt
            # tuning, or logits
            out = res if hasattr(res, "logits") or torch.is_tensor(res) \
                else res[0]
            self.logits.append(getattr(out, "logits", out))
            return res

        return step

    def _profiled(self, step_fn, args):
        res, self.busy_ms, self.table = profiled(step_fn, *args)
        return res

    def check(self, sample_batch: int, n_classes: int) -> None:
        for logits in self.logits:
            if logits.shape != (sample_batch, n_classes):
                raise AssertionError(f"logits shape {tuple(logits.shape)}")
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite logits")


def launch_counts(fa, tq) -> dict:
    from ttl_tpu_torch.ops.ln_matmul import ln_matmul
    return {"K1": fa.attention_bshd.fwd_launches,
            "K2": fa.attention_bshd.bwd_launches,
            "K3 fwd": fa.attention_per_head.fwd_launches,
            "K3 bwd": fa.attention_per_head.bwd_launches,
            "K4 fwd": fa.attention_heads.fwd_launches,
            "K4 bwd": fa.attention_heads.bwd_launches,
            "K5": tq.linear_q.launches, "K6": ln_matmul.launches}


@contextlib.contextmanager
def attention_route(fa, value):
    """Run with TTL_FUSED_ATTENTION set to `value` (None: unset), the way a
    user chooses the route, and put the environment back after."""
    before = os.environ.get("TTL_FUSED_ATTENTION")
    if value is None:
        os.environ.pop("TTL_FUSED_ATTENTION", None)
    else:
        os.environ["TTL_FUSED_ATTENTION"] = value
    fa.reset_mode()
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TTL_FUSED_ATTENTION", None)
        else:
            os.environ["TTL_FUSED_ATTENTION"] = before
        fa.reset_mode()


def reset_counts(fa, tq) -> None:
    from ttl_tpu_torch.ops.ln_matmul import ln_matmul
    fa.reset_launch_counts()
    tq.linear_q.launches = 0
    ln_matmul.launches = 0


def step_factory(cfg) -> str:
    """The name of the runner's step factory that `cfg` goes through."""
    if cfg.cocoop:
        return "make_fused_cocoop_fn"
    if cfg.tta_steps == 0:
        return "make_fused_zeroshot_fn"
    if cfg.lora_encoder == "prompt":
        return "make_fused_tpt_fn"
    return "make_fused_ttl_fn"


def drive(cfg, probe, n_images: int):
    """runner.run over `n_images` synthetic images with `probe` in the place
    of the step factory; the run's results."""
    from ttl_tpu_torch import runner
    attr = step_factory(cfg)
    original = getattr(runner, attr)
    setattr(runner, attr, probe)
    try:
        res = runner.run(cfg, device=torch.device("cuda"),
                         datasets={"A": SyntheticImages(n_images)})
    finally:
        setattr(runner, attr, original)
    probe.check(cfg.sample_batch, 200)
    return res


def phase_path(fa, tq, name: str, cfg, per_batch: dict,
               timed: bool = True) -> dict:
    """Drive runner.run over 16 images and check the launches per batch
    (kernels `per_batch` does not name must not launch); then, if `timed`,
    time 80 images in steady state, with the run's peak device memory, and
    profile one batch."""
    from ttl_tpu_torch import runner

    original = getattr(runner, step_factory(cfg))
    per_batch = {**dict.fromkeys(launch_counts(fa, tq), 0), **per_batch}

    probe = StepProbe(original)
    start = time.perf_counter()
    reset_counts(fa, tq)
    res = drive(cfg, probe, 16)
    counts = launch_counts(fa, tq)
    n_batches = len(probe.starts)
    log(f"{name}: {n_batches} batches, launches {counts}, top1/top5 "
        f"{res['A']}, whole run {time.perf_counter() - start:.1f} s")
    expect = {k: v * n_batches for k, v in per_batch.items()}
    if n_batches != 2 or counts != expect:
        raise AssertionError(f"{name}: expected {per_batch} launches per "
                             f"batch, got {counts} over {n_batches} batches")
    top1, top5 = res["A"]
    if not (0.0 <= top1 <= 100.0 and 0.0 <= top5 <= 100.0):
        raise AssertionError(f"top-1/top-5 out of range: {res['A']}")
    if not timed:
        return {"launches": counts}

    # throughput: a longer run through the runner's own pipeline. Once
    # pipeline_depth + 1 steps are queued, each dispatch waits for an older
    # step's counts, so the dispatch clock ticks at the steady batch rate.
    timing = StepProbe(original)
    torch.cuda.reset_peak_memory_stats()
    drive(cfg, timing, 80)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pace = np.diff(timing.starts[cfg.pipeline_depth + 1:])
    rate = cfg.sample_batch / np.median(pace)
    log(f"{name} steady state: {len(pace)} batches of {cfg.sample_batch} "
        f"samples, s/batch {pace.tolist()}, median {np.median(pace):.4f} s, "
        f"samples/s {rate:.3f} (pipeline_depth {cfg.pipeline_depth}), peak "
        f"device memory {peak_gb:.3f} GB")

    profiled = StepProbe(original, profile=True)
    drive(cfg, profiled, cfg.sample_batch)
    busy_s = profiled.busy_ms / 1e3
    log(f"{name}, one batch under torch.profiler: device busy {busy_s:.4f} "
        f"s, {100 * busy_s / np.median(pace):.1f}% of the steady s/batch; "
        f"top CUDA kernels:\n{profiled.table}")
    return {"launches": counts, "samples_per_s": rate,
            "busy_share": busy_s / np.median(pace), "peak_gb": peak_gb,
            "busy_ms": profiled.busy_ms}


class Sample(NamedTuple):
    """One sample through a path: its logits ([C]; for CoCoOp [2, C],
    `logits` above `adapted_logits`), the gradient its adaptation step
    handed AdamW at the first update, flat in f32 (None without AdamW), and
    the views the first DeYO loss kept (None off the DeYO paths)."""
    logits: torch.Tensor
    grad: Optional[torch.Tensor]
    keep: Optional[torch.Tensor] = None


@contextlib.contextmanager
def first_keep_mask():
    """Record the views the step's first `deyo_loss` keeps (`adapt.ttl`'s
    module global): a list that holds the mask once the step has run."""
    from ttl_tpu_torch.adapt import ttl
    deyo, seen = ttl.deyo_loss, []

    def recording(*args, **kw):
        loss, aux = deyo(*args, **kw)
        if not seen:
            seen.append(aux["keep"].detach().cpu())
        return loss, aux

    ttl.deyo_loss = recording
    try:
        yield seen
    finally:
        ttl.deyo_loss = deyo


@contextlib.contextmanager
def first_update_gradient():
    """Record the gradients of the trainable state (the LoRA A and B
    leaves, or the ctx) that the package's steps pass to their AdamW
    (`adapt.ttl._adamw`, which `adapt.cocoop` imports) at the first
    update: a list that holds them, concatenated, once the step has run."""
    from ttl_tpu_torch.adapt import cocoop, ttl
    adamw, seen = ttl._adamw, []

    def recording(params, grads, *rest):
        if not seen:
            seen.append(torch.cat([g.detach().float().flatten().cpu()
                                   for g in grads]))
        return adamw(params, grads, *rest)

    ttl._adamw = cocoop._adamw = recording
    try:
        yield seen
    finally:
        ttl._adamw = cocoop._adamw = adamw


def sample_step(cfg, image_seed: int = SEED + 1):
    """run_on(device) -> one fixed sample through `cfg`'s path as a
    `Sample`, with weights made on the card and moved to `device`.
    `image_seed` makes the sample's pixels."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt.ttl import (make_fused_cocoop_fn,
                                         make_fused_tpt_fn,
                                         make_fused_ttl_fn,
                                         make_fused_zeroshot_fn)
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.models.clip import tree_map
    from ttl_tpu_torch.models.prompts import prompt_tokens

    dev = torch.device("cuda")
    clip_cfg, params = runner.load_model(cfg, dev)
    host = sample_canvas(image_seed)
    draws = runner.sample_draws(cfg, [3])

    def moved(state, put):
        """A dataclass of tensors (and static fields) with its tensors put."""
        return dataclasses.replace(state, **{
            f.name: put(getattr(state, f.name))
            for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))})

    if cfg.cocoop:
        co_state = runner.cocoop_state("A", cfg, clip_cfg, params)
        cocoop = make_fused_cocoop_fn(clip_cfg, cfg)

        def step(put):
            res = cocoop(tree_map(put, params), moved(co_state, put),
                         put(host["canvases"]), put(host["hs"]),
                         put(host["ws"]), tree_map(put, draws))
            return torch.stack([res.logits, res.adapted_logits], dim=1)
    elif cfg.tta_steps > 0 and cfg.lora_encoder == "prompt":
        pl_state = runner.prompt_learner("A", cfg, params)
        tune = make_fused_tpt_fn(clip_cfg, cfg)

        def step(put):
            return tune(tree_map(put, params), moved(pl_state, put),
                        put(host["canvases"]), put(host["hs"]),
                        put(host["ws"]), tree_map(put, draws))[0].logits
    elif cfg.tta_steps > 0:
        adapters0 = runner.make_adapters0(cfg, clip_cfg, dev)
        text_mode = cfg.lora_encoder == "text"
        text_cls = None if text_mode else runner.text_classifier(
            "A", cfg, clip_cfg, params, device=dev)
        fused = make_fused_ttl_fn(
            clip_cfg, cfg, tokens=prompt_tokens(
                resolve_classnames("A"), cfg.ctx_init.replace("_", " "))
            if text_mode else None)

        def step(put):
            return fused(tree_map(put, params),
                         None if text_mode else put(text_cls),
                         tree_map(put, adapters0), put(host["canvases"]),
                         put(host["hs"]), put(host["ws"]),
                         tree_map(put, draws)).logits
    else:
        text_cls = runner.text_classifier("A", cfg, clip_cfg, params,
                                          device=dev)
        zeroshot = make_fused_zeroshot_fn(clip_cfg, cfg)

        def step(put):
            return zeroshot(tree_map(put, params), put(text_cls),
                            put(host["canvases"]), put(host["hs"]),
                            put(host["ws"]))

    def run_on(device) -> Sample:
        with first_update_gradient() as grads, first_keep_mask() as keep:
            logits = step(lambda t: t.to(device))[0].float().cpu()
        return Sample(logits, grads[0] if grads else None,
                      keep[0][0] if keep else None)

    return run_on


def sample_canvas(image_seed: int) -> dict:
    """The card-against-CPU sample: a 200 x 256 image of uniform noise from
    `image_seed` on a 256-pixel canvas, as uint8 canvases, hs and ws."""
    rng = np.random.default_rng(image_seed)
    canvas = np.zeros((1, 256, 256, 3), np.uint8)
    canvas[0, :200, :256] = rng.integers(0, 256, (200, 256, 3),
                                         dtype=np.uint8)
    return {"canvases": torch.from_numpy(canvas),
            "hs": torch.tensor([200]), "ws": torch.tensor([256])}


def card_and_cpu(cfg, **sample):
    """One sample through the CUDA path and through the plain path on the
    CPU, same weights (made, and quantised, on the card) and view draws:
    (card `Sample`, CPU `Sample`, CPU seconds)."""
    run_on = sample_step(cfg, **sample)
    card = run_on(torch.device("cuda"))
    t0 = time.perf_counter()
    cpu = run_on(torch.device("cpu"))
    return card, cpu, time.perf_counter() - t0


def expect_close(name: str, card, cpu, bound: float, cpu_s: float) -> None:
    diff = (card - cpu).abs().max().item()
    top2 = cpu.topk(2).values
    log(f"card vs CPU, {name}: top-1 {int(card.argmax())} vs "
        f"{int(cpu.argmax())} (CPU margin to the second "
        f"{(top2[0] - top2[1]).item():.4f}), max_abs_diff {diff:.3e} (bound "
        f"{bound:.3e}), logits range [{cpu.min().item():.3f}, "
        f"{cpu.max().item():.3f}], CPU run {cpu_s:.1f} s")
    if int(card.argmax()) != int(cpu.argmax()) or not diff <= bound:
        raise AssertionError(f"card and CPU disagree ({name})")


def relative_gradient_error(card: Sample, cpu: Sample) -> float:
    """max |card - CPU| of the first update's gradient over its largest
    element on the CPU."""
    return ((card.grad - cpu.grad).abs().max()
            / cpu.grad.abs().max()).item()


def expect_adapted(name: str, card: Sample, cpu: Sample, bound: float,
                   cpu_s: float, row: int = 0) -> None:
    """A path whose logits come after an AdamW step: they must agree at
    top-1 (their largest difference is printed, held to nothing), and the
    gradient that step took within `bound` of its largest element."""
    card_l, cpu_l = card.logits.reshape(-1, card.logits.shape[-1])[row], \
        cpu.logits.reshape(-1, cpu.logits.shape[-1])[row]
    err = relative_gradient_error(card, cpu)
    top2 = cpu_l.topk(2).values
    if card.keep is not None:
        log(f"card vs CPU, {name}: the first DeYO loss kept "
            f"{int(card.keep.sum())} views on the card, "
            f"{int(cpu.keep.sum())} on the CPU, "
            f"{int((card.keep != cpu.keep).sum())} kept on one side only")
    log(f"card vs CPU, {name}: top-1 {int(card_l.argmax())} vs "
        f"{int(cpu_l.argmax())} (CPU margin to the second "
        f"{(top2[0] - top2[1]).item():.4f}), logits max_abs_diff "
        f"{(card_l - cpu_l).abs().max().item():.3e}; first update's "
        f"gradient ({cpu.grad.numel()} elements, largest "
        f"{cpu.grad.abs().max().item():.3e}): max_abs_diff / largest "
        f"{err:.3e} (bound {bound:.3e}); CPU run {cpu_s:.1f} s")
    if int(card_l.argmax()) != int(cpu_l.argmax()) or not err <= bound:
        raise AssertionError(f"card and CPU disagree ({name})")


def phase_card_vs_cpu(cfg, name: str, path: str = ""):
    """Card against CPU: the logits within CARD_CPU_BOUND where no AdamW
    step comes before them (zero-shot), else `expect_adapted` within
    GRAD_BOUND_REL[path]. Returns the (card, CPU) `Sample`s."""
    card, cpu, cpu_s = card_and_cpu(cfg)
    if card.grad is None:
        expect_close(name, card.logits, cpu.logits, CARD_CPU_BOUND, cpu_s)
    else:
        expect_adapted(name, card, cpu, GRAD_BOUND_REL[path], cpu_s)
    return card, cpu


def log_einsum_yardstick(fa, cfg, name: str, cpu: Sample) -> None:
    """The same sample on the card through the einsum route (no hand-written
    attention kernel) against the CPU `Sample` of `phase_card_vs_cpu`: how
    far two correct runs of this path lie apart. Printed, held to nothing."""
    with attention_route(fa, "off"):
        card = sample_step(cfg)(torch.device("cuda"))
    log(f"card vs CPU, {name}, yardstick: the einsum route on the card "
        f"differs from the same CPU logits by "
        f"{(card.logits - cpu.logits).abs().max().item():.3e}, its first "
        f"update's gradient by {relative_gradient_error(card, cpu):.3e} of "
        f"the largest element")


def phase_cocoop_card_vs_cpu(cfg) -> None:
    """CoCoOp, card against CPU: `logits` (the clean view under its own
    unadapted ctx: the runner's result) within CARD_CPU_BOUND;
    `adapted_logits` (the clean view under the ctx the step tuned, which
    the 63 random views, the backward and AdamW reach) by
    `expect_adapted`."""
    card, cpu, cpu_s = card_and_cpu(cfg, image_seed=COCOOP_IMAGE_SEED)
    expect_close("CoCoOp logits", card.logits[0], cpu.logits[0],
                 CARD_CPU_BOUND, cpu_s)
    expect_adapted("CoCoOp adapted_logits", card, cpu,
                   GRAD_BOUND_REL["CoCoOp"], cpu_s, row=1)


def phase_int8_card_vs_cpu(name: str, flags: tuple, fp) -> None:
    """The path `flags` with the int8 prefix, card against CPU: zero-shot
    within CARD_CPU_BOUND plus the CPU's int8 effect, an adapted path by
    `expect_adapted` within its GRAD_BOUND_REL; the spread of the int8
    effect on the card must match the CPU's (EFFECT_SPREAD). `fp`: the
    (card, CPU) `Sample`s of the path without the int8 prefix."""
    card, cpu, cpu_s = card_and_cpu(config(*flags, "--prefix_quant", "int8"))
    on_card, on_cpu = card.logits - fp[0].logits, cpu.logits - fp[1].logits
    ratio = on_card.std().item() / on_cpu.std().item()
    log(f"{name}, int8 effect: max {on_card.abs().max().item():.3e} on the "
        f"card, {on_cpu.abs().max().item():.3e} on the CPU; spread over the "
        f"classes {on_card.std().item():.3e} on the card, "
        f"{on_cpu.std().item():.3e} on the CPU, ratio {ratio:.4f} (within "
        f"{EFFECT_SPREAD})")
    if card.grad is None:
        expect_close(name, card.logits, cpu.logits,
                     CARD_CPU_BOUND + on_cpu.abs().max().item(), cpu_s)
    else:
        expect_adapted(name, card, cpu, GRAD_BOUND_REL[name], cpu_s)
    if not EFFECT_SPREAD[0] <= ratio <= EFFECT_SPREAD[1]:
        raise AssertionError(f"{name}: the int8 effect on the card does not "
                             f"match the CPU's (spread ratio {ratio})")


def augmix_view_diff(cfg, image_seed: int = SEED + 1) -> dict:
    """One sample's views with AugMix (`cfg.aug_ops`) rendered in f32 on
    the card and on the CPU from the same draws, compared in [0, 1] units
    (the normalized difference times the CLIP std): the share of values
    that differ by more than 1/255, the largest difference among the
    others, and the share above 1e-4."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.ops.image import CLIP_STD, render_views
    host = sample_canvas(image_seed)
    draws = runner.sample_draws(cfg, [3])

    def views(device):
        put = lambda t: t.to(device)   # noqa: E731
        return render_views(*(put(host[k]) for k in ("canvases", "hs",
                                                     "ws")),
                            {k: put(t) for k, t in draws.items()},
                            out_size=cfg.resolution, out_dtype=torch.float32,
                            aug_ops=cfg.aug_ops).cpu()

    std = torch.tensor(CLIP_STD)[:, None, None]
    diff = ((views("cuda") - views("cpu")) * std).abs()
    step = diff > 1.0 / 255.0
    return {"step_share": step.float().mean().item(),
            "elsewhere": diff[~step].max().item(),
            "above_1e-4": (diff > 1e-4).float().mean().item()}


def view_maker_ms(cfg) -> tuple:
    """Device ms of `render_views` for one batch of `cfg.sample_batch`
    samples on 500-pixel canvases, with `cfg.aug_ops` and without (median
    of 5, CUDA events)."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt.ttl import compute_dtype
    from ttl_tpu_torch.ops.image import render_views
    n = cfg.sample_batch
    g = torch.Generator().manual_seed(SEED + 5)
    canvases = torch.randint(0, 256, (n, 500, 500, 3), generator=g,
                             dtype=torch.uint8).cuda()
    hs = torch.tensor([375, 480, 224, 500] * (n // 4 + 1))[:n].cuda()
    ws = torch.tensor([500, 320, 224, 375] * (n // 4 + 1))[:n].cuda()
    draws = {k: t.cuda() for k, t in runner.sample_draws(
        cfg, range(n)).items()}

    def render(aug_ops):
        return render_views(canvases, hs, ws, draws, out_size=cfg.resolution,
                            out_dtype=compute_dtype(cfg), aug_ops=aug_ops)

    return (median_ms(lambda: render(cfg.aug_ops), reps=5),
            median_ms(lambda: render(()), reps=5))


def phase_plpd(fa, tq) -> tuple:
    """PLPD (PLPD_FLAGS): the path timed (phase_path), one sample card
    against CPU, and the launches with the int8 prefix. Returns both paths'
    results."""
    cfg = config(*PLPD_FLAGS)
    path = phase_path(fa, tq, "PLPD", cfg, {"K1": 27, "K2": 3})
    phase_card_vs_cpu(cfg, "PLPD", "PLPD")
    int8 = phase_path(fa, tq, "PLPD, int8 prefix",
                      config("--prefix_quant", "int8", *PLPD_FLAGS),
                      {"K1": 27, "K2": 3, "K5": 108}, timed=False)
    return path, int8


def phase_augmix(fa, tq) -> dict:
    """`--aug_list` over DEFAULT_AUG_LIST: the path timed (phase_path), the
    view maker's time with and without AugMix, one sample's views card
    against CPU."""
    from ttl_tpu_torch.ops.augmix import DEFAULT_AUG_LIST
    cfg = config("--aug_list", ",".join(DEFAULT_AUG_LIST))
    path = phase_path(fa, tq, "AugMix", cfg, {"K1": 15, "K2": 3})
    aug_ms, plain_ms = view_maker_ms(cfg)
    log(f"AugMix view maker, one batch of {cfg.sample_batch} x "
        f"{cfg.batch_size} views (render_views, device): {aug_ms:.4f} ms "
        f"with AugMix, {plain_ms:.4f} ms without (the main path's)")
    d = augmix_view_diff(cfg)
    log(f"AugMix views, card vs CPU in f32: {100 * d['step_share']:.6f} % "
        f"of values differ by more than 1/255 (bound "
        f"{100 * AUGMIX_STEP_SHARE:.6f} %), {100 * d['above_1e-4']:.6f} % "
        f"by more than 1e-4 (bound {100 * AUGMIX_DIFF_SHARE:.6f} %); "
        f"largest difference elsewhere {d['elsewhere']:.3e}")
    if not (d["step_share"] <= AUGMIX_STEP_SHARE
            and d["above_1e-4"] <= AUGMIX_DIFF_SHARE):
        raise AssertionError("AugMix views: card and CPU disagree")
    return {**path, "view_ms": aug_ms, "plain_view_ms": plain_ms, **d}


def write_cocoop_checkpoint(path, n_ctx: int, width: int, proj_dim: int):
    """A CoCoOp checkpoint as the reference's trainer saves it (a state dict
    under 'state_dict', Linear weights as [out, in]), its ctx and meta-net
    drawn from a seeded generator."""
    g = torch.Generator().manual_seed(SEED + 21)
    hidden = proj_dim // 16

    def unif(shape, fan_in):
        return (torch.rand(shape, generator=g) * 2 - 1) / fan_in ** 0.5

    torch.save({"epoch": 10, "state_dict": {
        "prompt_learner.ctx": 0.02 * torch.randn(n_ctx, width, generator=g),
        "prompt_learner.meta_net.linear1.weight":
            unif((hidden, proj_dim), proj_dim),
        "prompt_learner.meta_net.linear1.bias": unif((hidden,), proj_dim),
        "prompt_learner.meta_net.linear2.weight":
            unif((width, hidden), hidden),
        "prompt_learner.meta_net.linear2.bias": unif((width,), hidden),
        "token_prefix": torch.zeros(3, 1, width),
        "token_suffix": torch.zeros(3, 72, width)}}, path)


def phase_cocoop_load(build_dir) -> float:
    """One batch of `--cocoop` with and without `--load`: the checkpoint's
    ctx and meta-net must reach the logits. Returns their largest
    difference."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.models.zoo import get_arch
    plain_cfg = config("--cocoop")
    clip_cfg = get_arch(plain_cfg.arch)
    path = os.path.join(build_dir, "cocoop_smoke_checkpoint.pth")
    write_cocoop_checkpoint(path, len(plain_cfg.ctx_init.split("_")),
                            clip_cfg.text.hidden, clip_cfg.vision.proj_dim)
    logits = []
    for cfg in (plain_cfg, config("--cocoop", "--load", path)):
        probe = StepProbe(runner.make_fused_cocoop_fn)
        drive(cfg, probe, cfg.sample_batch)
        logits.append(probe.logits[0].float())
    diff = (logits[0] - logits[1]).abs().max().item()
    log(f"CoCoOp --load {path}: one batch with and without the checkpoint, "
        f"max |difference of the logits| {diff:.4f}")
    if not diff > 1e-2:
        raise AssertionError("--load left the CoCoOp logits as they were")
    return diff


RN50_PROMPT_FLAGS = ("-a", "RN50", "--lora_encoder", "prompt")


def phase_resnet(fa, tq) -> tuple:
    """RN50 prompt tuning under heads and RN50 zero-shot on the default
    route: each path timed (phase_path) and one sample card against CPU.
    Returns both paths' results."""
    tpt_cfg = config(*RN50_PROMPT_FLAGS)
    with attention_route(fa, "heads"):
        tpt = phase_path(fa, tq, "RN50 prompt tuning, heads route", tpt_cfg,
                         {"K4 fwd": 48, "K4 bwd": 12})
        phase_card_vs_cpu(tpt_cfg, "RN50 prompt tuning, heads route",
                          "RN50 prompt tuning")
    zs_cfg = config("-a", "RN50", "--tta_steps", "0")
    zero_shot = phase_path(fa, tq, "RN50 zero-shot", zs_cfg, {})
    phase_card_vs_cpu(zs_cfg, "RN50 zero-shot")
    return tpt, zero_shot


def seeded_weights(arch: str, seed: int) -> dict:
    """Random f32 weights of `arch` on the host in the port's layout, drawn
    from `seed`; a ResNet's batchnorms get drawn running statistics."""
    from ttl_tpu_torch.models.clip import init_clip_params
    from ttl_tpu_torch.models.zoo import get_arch
    g = torch.Generator().manual_seed(seed)
    params = init_clip_params(get_arch(arch), g, device="cpu")

    def statistics_of(tree):
        if isinstance(tree, dict) and "var" in tree:
            n = tree["var"].shape
            return {"scale": 1 + 0.1 * torch.randn(n, generator=g),
                    "bias": 0.1 * torch.randn(n, generator=g),
                    "mean": 0.1 * torch.randn(n, generator=g),
                    "var": 0.5 + torch.rand(n, generator=g)}
        if isinstance(tree, dict):
            return {k: statistics_of(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [statistics_of(v) for v in tree]
        return tree

    return {**params, "vision": statistics_of(params["vision"])}


def openai_rn_state_dict(p: dict) -> dict:
    """The port's RN-family parameters as OpenAI's clip names them (the
    inverse of models.convert.from_openai_state_dict), fp16 as published."""
    sd = {"logit_scale": p["logit_scale"]}
    v, t = p["vision"], p["text"]

    def bn(prefix, b):
        sd.update({f"{prefix}.weight": b["scale"], f"{prefix}.bias": b["bias"],
                   f"{prefix}.running_mean": b["mean"],
                   f"{prefix}.running_var": b["var"]})

    for i in (1, 2, 3):
        sd[f"visual.conv{i}.weight"] = v[f"conv{i}"]
        bn(f"visual.bn{i}", v[f"bn{i}"])
    for stage in range(1, 5):
        for b, bp in enumerate(v[f"layer{stage}"]):
            pre = f"visual.layer{stage}.{b}"
            for i in (1, 2, 3):
                sd[f"{pre}.conv{i}.weight"] = bp[f"conv{i}"]
                bn(f"{pre}.bn{i}", bp[f"bn{i}"])
            if "downsample" in bp:
                sd[f"{pre}.downsample.0.weight"] = bp["downsample"]["conv"]
                bn(f"{pre}.downsample.1", bp["downsample"]["bn"])
    ap = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = ap["pos_embed"]
    for name, key in (("q", "q"), ("k", "k"), ("v", "v"), ("c", "out")):
        sd[f"visual.attnpool.{name}_proj.weight"] = ap[key]["w"].T
        sd[f"visual.attnpool.{name}_proj.bias"] = ap[key]["b"]
    sd.update({"token_embedding.weight": t["token_embed"],
               "positional_embedding": t["pos_embed"],
               "ln_final.weight": t["ln_final"]["scale"],
               "ln_final.bias": t["ln_final"]["bias"],
               "text_projection": t["proj"]})
    lay = t["layers"]
    for i in range(lay["ln1"]["scale"].shape[0]):
        pre = f"transformer.resblocks.{i}"
        attn, mlp = lay["attn"], lay["mlp"]
        sd.update({
            f"{pre}.attn.in_proj_weight":
                torch.cat([attn[n]["w"][i].T for n in "qkv"]),
            f"{pre}.attn.in_proj_bias":
                torch.cat([attn[n]["b"][i] for n in "qkv"]),
            f"{pre}.attn.out_proj.weight": attn["o"]["w"][i].T,
            f"{pre}.attn.out_proj.bias": attn["o"]["b"][i],
            f"{pre}.ln_1.weight": lay["ln1"]["scale"][i],
            f"{pre}.ln_1.bias": lay["ln1"]["bias"][i],
            f"{pre}.ln_2.weight": lay["ln2"]["scale"][i],
            f"{pre}.ln_2.bias": lay["ln2"]["bias"][i],
            f"{pre}.mlp.c_fc.weight": mlp["fc1"]["w"][i].T,
            f"{pre}.mlp.c_fc.bias": mlp["fc1"]["b"][i],
            f"{pre}.mlp.c_proj.weight": mlp["fc2"]["w"][i].T,
            f"{pre}.mlp.c_proj.bias": mlp["fc2"]["b"][i]})
    return {k: x.contiguous().half() for k, x in sd.items()}


def hf_vit_state_dict(p: dict, cfg) -> dict:
    """The port's ViT parameters as HuggingFace's CLIPModel names them (the
    inverse of models.convert.from_hf_state_dict), fp16."""
    v, t = p["vision"], p["text"]
    patch = cfg.vision.patch
    sd = {"logit_scale": p["logit_scale"],
          "vision_model.embeddings.patch_embedding.weight":
              v["patch_embed"].T.reshape(-1, 3, patch, patch),
          "vision_model.embeddings.class_embedding": v["class_embed"],
          "vision_model.embeddings.position_embedding.weight": v["pos_embed"],
          "vision_model.pre_layrnorm.weight": v["ln_pre"]["scale"],
          "vision_model.pre_layrnorm.bias": v["ln_pre"]["bias"],
          "vision_model.post_layernorm.weight": v["ln_post"]["scale"],
          "vision_model.post_layernorm.bias": v["ln_post"]["bias"],
          "visual_projection.weight": v["proj"].T,
          "text_model.embeddings.token_embedding.weight": t["token_embed"],
          "text_model.embeddings.position_embedding.weight": t["pos_embed"],
          "text_model.final_layer_norm.weight": t["ln_final"]["scale"],
          "text_model.final_layer_norm.bias": t["ln_final"]["bias"],
          "text_projection.weight": t["proj"].T}
    for tower, lay in (("vision_model", v["layers"]),
                       ("text_model", t["layers"])):
        for i in range(lay["ln1"]["scale"].shape[0]):
            pre = f"{tower}.encoder.layers.{i}"
            for n, ln in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
                sd[f"{pre}.{n}.weight"] = lay[ln]["scale"][i]
                sd[f"{pre}.{n}.bias"] = lay[ln]["bias"][i]
            for n, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                           ("out_proj", "o")):
                sd[f"{pre}.self_attn.{n}.weight"] = lay["attn"][key]["w"][i].T
                sd[f"{pre}.self_attn.{n}.bias"] = lay["attn"][key]["b"][i]
            for n in ("fc1", "fc2"):
                sd[f"{pre}.mlp.{n}.weight"] = lay["mlp"][n]["w"][i].T
                sd[f"{pre}.mlp.{n}.bias"] = lay["mlp"][n]["b"][i]
    return {k: x.contiguous().half() for k, x in sd.items()}


def one_batch(fa, tq, cfg, per_batch: dict, name: str) -> torch.Tensor:
    """One batch of `cfg` through runner.run: its launches checked against
    `per_batch` (every kernel it does not name: none), its logits."""
    from ttl_tpu_torch import runner
    probe = StepProbe(getattr(runner, step_factory(cfg)))
    expect = {**dict.fromkeys(launch_counts(fa, tq), 0), **per_batch}
    reset_counts(fa, tq)
    drive(cfg, probe, cfg.sample_batch)
    counts = launch_counts(fa, tq)
    log(f"{name}: one batch, launches {counts}")
    if len(probe.logits) != 1 or counts != expect:
        raise AssertionError(f"{name}: expected {per_batch} launches in one "
                             f"batch, got {counts} over "
                             f"{len(probe.logits)} batches")
    return probe.logits[0]


def phase_checkpoints(fa, tq, build_dir) -> dict:
    """`--checkpoint_path` with the two synthetic checkpoints: for each, one
    batch from the file and one from the `.npz` that `save_pytree` makes of
    the loaded params, which must give the same bits; and three loaded
    leaves of the RN50 file against its tensors. Returns each run's
    launches."""
    import tempfile
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.models.convert import save_pytree
    from ttl_tpu_torch.models.zoo import get_arch
    runs = {"RN50 prompt tuning from a checkpoint":
            (RN50_PROMPT_FLAGS, "heads", {"K4 fwd": 48, "K4 bwd": 12}),
            "main path from a checkpoint":
            ((), None, {"K1": 15, "K2": 3})}
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        rn_sd = openai_rn_state_dict(seeded_weights("RN50", SEED + 31))
        vit_sd = hf_vit_state_dict(seeded_weights("ViT-B/16", SEED + 32),
                                   get_arch("ViT-B/16"))
        files = {}
        for name, sd in zip(runs, (rn_sd, vit_sd)):
            files[name] = os.path.join(tmp, f"{len(files)}.pt")
            torch.save(sd, files[name])
            log(f"{name}: wrote {files[name]} "
                f"({os.path.getsize(files[name]) / 1e6:.1f} MB, "
                f"{len(sd)} fp16 tensors)")
        for name, (flags, route, per_batch) in runs.items():
            cfg = config(*flags, "--checkpoint_path", files[name])
            with attention_route(fa, route):
                from_file = one_batch(fa, tq, cfg, per_batch, name)
                _, params = runner.load_model(cfg, torch.device("cuda"))
                cache = files[name][:-3] + ".npz"
                save_pytree(cache, params)
                from_cache = one_batch(
                    fa, tq, config(*flags, "--checkpoint_path", cache),
                    per_batch, f"{name}, from the .npz")
            same = torch.equal(from_file, from_cache)
            log(f"{name}: logits from the file and from the .npz "
                f"{'have the same bits' if same else 'differ'} "
                f"(max |difference| "
                f"{(from_file - from_cache).abs().max().item():.3e})")
            if not same:
                raise AssertionError(f"{name}: the .npz cache changed the "
                                     "logits")
            if name.startswith("RN50"):
                q = rn_sd["transformer.resblocks.5.attn.in_proj_weight"]
                spots = {
                    "visual.conv1.weight": (params["vision"]["conv1"],
                                            rn_sd["visual.conv1.weight"]),
                    "visual.attnpool.c_proj.weight": (
                        params["vision"]["attnpool"]["out"]["w"],
                        rn_sd["visual.attnpool.c_proj.weight"].T),
                    "transformer.resblocks.5 q": (
                        params["text"]["layers"]["attn"]["q"]["w"][5],
                        q[:q.shape[1]].T)}
                for leaf, (loaded, file_t) in spots.items():
                    if not torch.equal(loaded.cpu(),
                                       file_t.to(loaded.dtype)):
                        raise AssertionError(f"{leaf}: the loaded leaf is "
                                             "not the file's tensor")
                log(f"{name}: {', '.join(spots)} equal the file's tensors "
                    f"after the layout change")
            out[name] = {"launches": launch_counts(fa, tq)}
            del params
    return out


# ------------------------------------------------ the product surfaces

# predict's flags in phase 27: set I's 1000 classes, and every class in
# each line's `topk`, so that its probabilities sum to 1
PREDICT_FLAGS = ("--test_sets", "I", "--topk", "1000")
# predict's probabilities are rounded to 6 places: the error of a sum of
# 1000 of them has a standard deviation of 9.1e-6 (uniform errors within
# 5e-7), so 1e-4 holds it at 11 deviations
PROB_SUM_BOUND = 1e-4


def write_images(directory: str, n: int, seed: int, hue=None) -> list:
    """`n` images of uniform noise at SyntheticImages' sizes into
    `directory`, JPEG and PNG in turn; with `hue`, that channel raised to at
    least 160. Returns their paths."""
    from PIL import Image
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        size = SyntheticImages.SIZES[i % len(SyntheticImages.SIZES)]
        img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        if hue is not None:
            img[..., hue] = np.maximum(img[..., hue], 160)
        paths.append(os.path.join(directory,
                                  f"{i:03d}.{('jpg', 'png')[i % 2]}"))
        Image.fromarray(img).save(paths[-1])
    return paths


def run_predict(fa, tq, name: str, images: str, flags: tuple,
                per_batch: dict, profile: bool = False):
    """`python -m ttl_tpu_torch.predict IMAGES --test_sets I --topk 1000
    --out FILE *flags` through its `main`, with a StepProbe in the place of
    its step factory; the launches per batch checked against `per_batch`
    (every kernel it does not name: none). Returns (the JSON lines, the
    launches, the probe, the seconds of the call)."""
    from ttl_tpu_torch import predict
    from ttl_tpu_torch.adapt import ttl
    attr = ("make_fused_zeroshot_fn" if "--tta_steps" in flags
            else "make_fused_ttl_fn")
    original = getattr(ttl, attr)
    probe = StepProbe(original, profile=profile)
    out = images + ".jsonl"
    reset_counts(fa, tq)
    setattr(ttl, attr, probe)
    start = time.perf_counter()
    try:
        predict.main([images, *PREDICT_FLAGS, "--out", out, *flags])
    finally:
        setattr(ttl, attr, original)
    seconds = time.perf_counter() - start
    counts = launch_counts(fa, tq)
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    n_batches = len(probe.starts)
    expect = {k: v * n_batches
              for k, v in {**dict.fromkeys(counts, 0), **per_batch}.items()}
    log(f"{name}: {len(lines)} lines, {n_batches} batches, launches "
        f"{counts}, whole call {seconds:.1f} s")
    if counts != expect:
        raise AssertionError(f"{name}: expected {per_batch} launches per "
                             f"batch, got {counts} over {n_batches} batches")
    return lines, counts, probe, seconds


def check_predictions(name: str, lines: list, n_images: int, classes: list,
                      topk: int) -> None:
    """predict's JSON lines: one per image, each label its top class, `topk`
    probabilities, finite and descending, summing to 1 within
    PROB_SUM_BOUND where they are every class's, else to no more."""
    if len(lines) != n_images:
        raise AssertionError(f"{name}: {len(lines)} lines for {n_images} "
                             "images")
    for r in lines:
        probs = np.array([t["prob"] for t in r["topk"]])
        gap = probs.sum() - 1.0
        if (r["label"] != r["topk"][0]["label"]
                or r["zero_shot_label"] not in classes
                or len(probs) != topk
                or not np.isfinite(probs).all()
                or (np.diff(probs) > 0).any()
                or gap > PROB_SUM_BOUND
                or (topk == len(classes) and gap < -PROB_SUM_BOUND)):
            raise AssertionError(f"{name}: a malformed line for "
                                 f"{r['path']}")


def phase_predict(fa, tq, build_dir) -> dict:
    """Batch prediction at full width through `predict.main`: 24 images of
    mixed sizes (JPEG and PNG) over set I's 1000 classes, adapted (the main
    path and the zero-shot aux pass: 18 K1 and 3 K2 a batch), at
    `--tta_steps 0` (12 K1) and with `--prefix_quant int8` (54 K5 more);
    then 80 images timed in steady state as phase 4 times the main path,
    (at the default `--topk 5` and with every class written), and one batch
    under torch.profiler. Returns each run's launches, and the adapted
    run's rate at `--topk 5`."""
    import tempfile
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.predict import IN_FLIGHT
    classes = list(resolve_classnames("I"))
    adapted = {"K1": 18, "K2": 3}
    runs = {"predict": ((), adapted),
            "predict, --tta_steps 0": (("--tta_steps", "0"), {"K1": 12}),
            "predict, int8 prefix": (("--prefix_quant", "int8"),
                                     {**adapted, "K5": 54})}
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        images = os.path.join(tmp, "images")
        write_images(images, 24, SEED + 41)
        for name, (flags, per_batch) in runs.items():
            lines, counts, probe, _ = run_predict(fa, tq, name, images, flags,
                                                  per_batch)
            check_predictions(name, lines, 24, classes, len(classes))
            probe.check(8, len(classes))
            if "--tta_steps" in flags and any(
                    r["label"] != r["zero_shot_label"] for r in lines):
                raise AssertionError(f"{name}: a label differs from the "
                                     "zero-shot label")
            changed = sum(r["label"] != r["zero_shot_label"] for r in lines)
            log(f"{name}: every line checked; the adapted label differs "
                f"from the zero-shot label on {changed} of 24 images")
            out[name] = {"launches": counts}

        # timed at the default --topk 5, then with every class written
        timed = os.path.join(tmp, "timed")
        write_images(timed, 80, SEED + 42)
        for topk in (5, len(classes)):
            name = f"predict, 80 images, --topk {topk}"
            torch.cuda.reset_peak_memory_stats()
            lines, _, timing, seconds = run_predict(
                fa, tq, name, timed, ("--topk", str(topk)), adapted)
            check_predictions(name, lines, 80, classes, topk)
            pace = np.diff(timing.starts[IN_FLIGHT + 1:])
            log(f"{name}, steady state: {len(pace)} batches of 8 images, "
                f"s/batch {pace.tolist()}, median {np.median(pace):.4f} s, "
                f"images/s {8 / np.median(pace):.3f} (in flight "
                f"{IN_FLIGHT}), the whole call {80 / seconds:.3f} images/s "
                f"with the set-up, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
            if topk == 5:
                rate = 8 / np.median(pace)
                step_s = np.median(pace)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
        one = os.path.join(tmp, "one")
        write_images(one, 8, SEED + 43)
        _, _, prof, _ = run_predict(fa, tq, "predict, one batch profiled",
                                    one, (), adapted, profile=True)
        busy_s = prof.busy_ms / 1e3
        log(f"predict, one batch under torch.profiler: device busy "
            f"{busy_s:.4f} s, {100 * busy_s / step_s:.1f}% of the steady "
            f"s/batch at --topk 5; top CUDA kernels:\n{prof.table}")
    out["predict"].update(samples_per_s=rate, peak_gb=peak_gb,
                          busy_ms=prof.busy_ms, busy_share=busy_s / step_s)
    return out


def phase_predictor_card_vs_cpu() -> None:
    """`TTLPredictor`'s fused step (`make_fused_ttl_fn(...,
    zero_shot_aux=True)`) for phase 5's sample over set A, on the card and
    on the CPU (plain versions), same weights and draws: the adapted logits
    at top-1 and the first update's gradient within
    GRAD_BOUND_REL["main path"] (`expect_adapted`), the zero-shot logits of
    the aux pass within CARD_CPU_BOUND."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.models.clip import tree_map
    from ttl_tpu_torch.serve import TTLPredictor
    cfg = config()
    pred = TTLPredictor(resolve_classnames("A"), cfg,
                        device=torch.device("cuda"), warmup=False)
    host = sample_canvas(SEED + 1)
    draws = runner.sample_draws(cfg, [3])

    def run_on(device):
        def put(t):
            return t.to(device)
        with first_update_gradient() as grads:
            res = pred.step_fn(tree_map(put, pred.params),
                               put(pred.text_cls),
                               tree_map(put, pred.adapters0),
                               put(host["canvases"]), put(host["hs"]),
                               put(host["ws"]), tree_map(put, draws))
        return (Sample(res.logits[0].float().cpu(), grads[0]),
                res.zero_shot_logits[0].float().cpu())

    card, card_zs = run_on(torch.device("cuda"))
    start = time.perf_counter()
    cpu, cpu_zs = run_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - start
    name = "TTLPredictor's step with the zero-shot aux pass"
    expect_adapted(name, card, cpu, GRAD_BOUND_REL["main path"], cpu_s)
    expect_close(f"{name}, zero_shot_logits", card_zs, cpu_zs,
                 CARD_CPU_BOUND, cpu_s)


def http(port: int, path: str, body: Optional[bytes] = None,
         timeout: float = 300):
    """One request to the local server: (status, its JSON body or None)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def jpeg(img: np.ndarray) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    return buf.getvalue()


def phase_serve() -> dict:
    """`python -m ttl_tpu_torch.serve --test_sets I --sample_batch 4
    --max_queue 64 --port P` as a user starts it, in a process of its own
    on the card: the seconds from its start to its READY line ("serving
    on") and from the first POST to its answer; then 16 JPEG POSTs and one
    malformed body at once (16 x 200 with labels of set I and 1 x 400,
    /metrics counting 16 more served, 1 more failed, 4 to 16 more batches
    and none shed); the first image, posted alone and again inside the
    burst, gets the same label and probabilities; then SIGTERM: the server
    drains and exits 0."""
    import signal
    import socket
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.ops import _build
    classes = set(resolve_classnames("I"))
    built = _build.library_path().exists()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "ttl_tpu_torch.serve", "--test_sets", "I",
           "--sample_batch", "4", "--max_queue", "64", "--port", str(port)]
    output, ready_at, ready = [], [], threading.Event()
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def read():
        for line in proc.stdout:
            output.append(line.rstrip())
            if "serving on" in line:
                ready_at.append(time.perf_counter())
                ready.set()
        ready.set()   # the process ended

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        ready.wait(600)
        if not ready_at:
            raise AssertionError("the server did not come up:\n"
                                 + "\n".join(output[-40:]))
        ready_s = ready_at[0] - start
        rng = np.random.default_rng(SEED + 51)
        bodies = [jpeg(rng.integers(0, 256, SyntheticImages.SIZES[i % 4]
                                    + (3,), dtype=np.uint8))
                  for i in range(16)]
        t0 = time.perf_counter()
        code, alone = http(port, "/predict", bodies[0])
        first_s = time.perf_counter() - t0
        if code != 200 or alone["label"] not in classes:
            raise AssertionError(f"the first POST answered {code}")
        before = http(port, "/metrics")[1]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=17) as ex:
            results = list(ex.map(lambda b: http(port, "/predict", b),
                                  bodies + [b"not an image"]))
        burst_s = time.perf_counter() - t0
        after = http(port, "/metrics")[1]
        codes = [c for c, _ in results]
        if codes != [200] * 16 + [400] or any(
                r["label"] not in classes for _, r in results[:16]):
            raise AssertionError(f"the burst answered {codes}")
        more = {k: after[k] - before[k]
                for k in ("served_total", "failed_total", "batches_total",
                          "shed_total")}
        log(f"serve: the burst of 17 answered in {burst_s:.3f} s; /metrics "
            f"after it {after}; the burst's share {more}")
        if (more["served_total"], more["failed_total"],
                more["shed_total"]) != (16, 1, 0) \
                or not 4 <= more["batches_total"] <= 16:
            raise AssertionError(f"serve: /metrics counted {more}")
        in_burst = results[0][1]
        if (in_burst["label"], in_burst["topk"], in_burst["zero_shot_label"]) \
                != (alone["label"], alone["topk"], alone["zero_shot_label"]):
            raise AssertionError("serve: the same image answered otherwise "
                                 "inside the burst")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"serve, stopped with SIGTERM: exit code {rc}; its last lines: "
        + " | ".join(output[-3:]))
    if rc != 0 or not any("draining" in line for line in output):
        raise AssertionError(f"serve did not drain and exit 0 (exit code "
                             f"{rc})")
    log(f"serve cold start (kernel library {'already built' if built else 'built by the server'}): "
        f"{ready_s:.3f} s from the process's start to its READY line, "
        f"{first_s:.3f} s from the first POST to its answer; the same image "
        f"alone and inside the burst: the same label and probabilities")
    return {"ready_s": ready_s, "first_response_s": first_s,
            "burst_s": burst_s}


def write_bongard(root: str, n_episodes: int, seed: int):
    """`n_episodes` Bongard episodes of 7 positive (red raised) and 7
    negative (blue raised) images each, and their split file, under `root`
    (tests/test_bongard_eval.py's layout): the dataset."""
    from ttl_tpu_torch.data.bongard import BongardDataset
    tasks = []
    for t in range(n_episodes):
        pos, neg = (write_images(os.path.join(root, f"t{t}", name), 7,
                                 seed + 2 * t + k, hue=hue)
                    for k, (name, hue) in enumerate((("pos", 0),
                                                     ("neg", 2))))
        tasks.append([[{"im_path": os.path.relpath(p, root)} for p in neg],
                      [{"im_path": os.path.relpath(p, root)} for p in pos],
                      "hold++cup"])
    with open(os.path.join(
            root, "bongard_hoi_test_unseen_obj_unseen_act.json"), "w") as f:
        json.dump(tasks, f)
    return BongardDataset(root, splits_dir=root)


def phase_bongard(fa, tq, build_dir) -> dict:
    """`--test_sets bongard` through `runner.run` at ViT-B/16 over 4
    synthetic episodes (6 + 6 support images and 2 queries each): adapted,
    12 K1 an episode for the support encoder and 15 K1 / 3 K2 for the
    queries' step, twice, with the same query logits' bits; zero-shot, 24
    K1 an episode; `-a RN50 --tta_steps 0`, no kernel launch. Then the
    adapted protocol timed (`adapt.bongard.evaluate_bongard` on the loaded
    model) and profiled. Returns each run's launches and the timing."""
    import tempfile
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt import bongard
    runs = {"Bongard": ((), {"K1": 27, "K2": 3}),
            "Bongard, again": ((), {"K1": 27, "K2": 3}),
            "Bongard zero-shot": (("--tta_steps", "0"), {"K1": 24}),
            "Bongard, RN50 zero-shot": (("-a", "RN50", "--tta_steps", "0"),
                                        {})}
    n_ep = 4
    out, logits = {}, {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ds = write_bongard(tmp, n_ep, SEED + 61)
        for name, (flags, per_episode) in runs.items():
            cfg = config("--test_sets", "bongard", *flags)
            probe = StepProbe(bongard.make_bongard_step_fn)
            bongard.make_bongard_step_fn = probe
            reset_counts(fa, tq)
            start = time.perf_counter()
            try:
                res = runner.run(cfg, device=torch.device("cuda"),
                                 datasets={"bongard": ds})["bongard"]
            finally:
                bongard.make_bongard_step_fn = probe.make_step
            counts = launch_counts(fa, tq)
            expect = {k: v * n_ep for k, v in {**dict.fromkeys(counts, 0),
                                               **per_episode}.items()}
            log(f"{name}: accuracy {res}, launches {counts} over {n_ep} "
                f"episodes, whole run {time.perf_counter() - start:.1f} s")
            if counts != expect or not 0.0 <= res[0] <= 100.0 \
                    or res[1] != 100.0:
                raise AssertionError(f"{name}: expected {per_episode} "
                                     f"launches an episode, got {counts}")
            out[name] = {"launches": counts, "accuracy": res}
            logits[name] = probe.logits
        same = all(torch.equal(a, b) for a, b in zip(logits["Bongard"],
                                                     logits["Bongard, again"]))
        if out["Bongard"]["accuracy"] != out["Bongard, again"]["accuracy"] \
                or len(logits["Bongard"]) != n_ep or not same:
            raise AssertionError("Bongard: two adapted runs differ")
        log("Bongard: two adapted runs gave the same accuracy and the same "
            "bits in every episode's query logits")

        cfg = config("--test_sets", "bongard")
        clip_cfg, params = runner.load_model(cfg, torch.device("cuda"))
        adapters0 = runner.make_adapters0(cfg, clip_cfg, torch.device("cuda"))

        def evaluate():
            return bongard.evaluate_bongard(cfg, ds, clip_cfg, params,
                                            adapters0, device="cuda")

        evaluate()
        torch.cuda.synchronize()
        start = time.perf_counter()
        evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        _, busy_ms, table = profiled(evaluate)
    n_images = n_ep * 14
    log(f"Bongard, adapted: {n_ep} episodes in {wall:.4f} s, "
        f"{n_ep / wall:.3f} episodes/s, {n_images / wall:.3f} images/s "
        f"(support and queries, decoding included); one pass under "
        f"torch.profiler: device busy {busy_ms / 1e3:.4f} s, "
        f"{100 * busy_ms / 1e3 / wall:.1f}% of the unprofiled pass; top CUDA "
        f"kernels:\n{table}")
    out["Bongard"].update(episodes_per_s=n_ep / wall,
                          images_per_s=n_images / wall, busy_ms=busy_ms,
                          busy_share=busy_ms / 1e3 / wall)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ttl_tpu_torch.ops import _build
    from ttl_tpu_torch.ops import attention as fa
    from ttl_tpu_torch.ops import ln_matmul as tlm
    from ttl_tpu_torch.ops import quant as tq

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({torch.cuda.device_count()} visible); nvidia-smi: "
        f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log("ptxas on the tensor-core attention kernels, by source (K1/K2: "
        "attention_bshd.cu, K3/K4: attention_bhsd.cu) <head dim, warps, rows "
        "a stage, stages>:")
    for key, used in sorted(_build.kernel_resources("mma_").items()):
        source, name = key.split(": ", 1)
        log(f"  {source} " + re.sub(
            r".*(mma_\w+?)ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E.*",
            r"\1<\2, \3, \4, \5>", name) + ": " + used)
    log("ptxas on K5's kernels (quant_matmul.cu):")
    for key, used in sorted(_build.kernel_resources("k5_").items()):
        log(f"  {key.split(': ', 1)[1]}: {used}")

    fwd = phase_forward(fa)
    bwd = phase_backward(fa)
    main_path = phase_path(fa, tq, "main path", config(),
                           {"K1": 15, "K2": 3, "K5": 0})
    main_fp = phase_card_vs_cpu(config(), "main path", "main path")
    other = phase_other_geometries(fa)
    k5 = phase_k5(tq)
    int8_path = phase_path(fa, tq, "int8 main path",
                           config("--prefix_quant", "int8"),
                           {"K1": 15, "K2": 3, "K5": 54})
    zero_shot = phase_path(fa, tq, "zero-shot",
                           config("--tta_steps", "0", "--prefix_quant",
                                  "int8", "--ensemble"),
                           {"K1": 12, "K2": 0, "K5": 72})
    phase_int8_card_vs_cpu("int8 main path", (), main_fp)
    zs_flags = ("--tta_steps", "0", "--ensemble")
    phase_int8_card_vs_cpu("zero-shot", zs_flags,
                           phase_card_vs_cpu(config(*zs_flags),
                                             "zero-shot without int8"))
    k3 = phase_bhsd(fa, "per_head", "K3")
    k4 = phase_bhsd(fa, "heads", "K4")
    lib_k1, lib_k2 = phase_bshd_yardstick(other)
    text_cfg = config("--lora_encoder", "text")
    prompt_cfg = config("--lora_encoder", "prompt")
    with attention_route(fa, "per_head"):
        text_path = phase_path(fa, tq, "text-LoRA, per_head route", text_cfg,
                               {"K3 fwd": 36, "K3 bwd": 3})
        _, text_cpu = phase_card_vs_cpu(text_cfg, "text-LoRA, per_head route",
                                        "text-LoRA")
    with attention_route(fa, "heads"):
        prompt_path = phase_path(fa, tq, "prompt tuning, heads route",
                                 prompt_cfg, {"K4 fwd": 60, "K4 bwd": 12})
        _, prompt_cpu = phase_card_vs_cpu(prompt_cfg,
                                          "prompt tuning, heads route",
                                          "prompt tuning")
    log_einsum_yardstick(fa, text_cfg, "text-LoRA", text_cpu)
    log_einsum_yardstick(fa, prompt_cfg, "prompt tuning", prompt_cpu)
    tpt_lora_cfg = config("--deyo_selection", "False")
    tpt_lora = phase_path(fa, tq, "TPT on LoRA", tpt_lora_cfg,
                          {"K1": 18, "K2": 3}, timed=False)
    phase_card_vs_cpu(tpt_lora_cfg, "TPT on LoRA", "TPT on LoRA")
    k6 = phase_k6(tlm)
    cocoop_cfg = config("--cocoop")
    cocoop_path = phase_path(fa, tq, "CoCoOp", cocoop_cfg,
                             {"K1": 12, "K6": 48})
    phase_cocoop_card_vs_cpu(cocoop_cfg)
    phase_cocoop_load(lib.parent)
    plpd_path, plpd_int8 = phase_plpd(fa, tq)
    augmix_path = phase_augmix(fa, tq)
    rn50_tpt, rn50_zero_shot = phase_resnet(fa, tq)
    checkpoints = phase_checkpoints(fa, tq, lib.parent)
    seconds = {}
    for phase, run in ((27, lambda: phase_predict(fa, tq, lib.parent)),
                       (28, phase_predictor_card_vs_cpu),
                       (29, phase_serve),
                       (30, lambda: phase_bongard(fa, tq, lib.parent))):
        start = time.perf_counter()
        seconds[phase] = (run(), time.perf_counter() - start)
        log(f"phase {phase} took {seconds[phase][1]:.1f} s")
    predict_runs, served, bongard_runs = (seconds[p][0] for p in (27, 29, 30))
    log(f"new paths: predict {predict_runs['predict']['samples_per_s']:.3f} "
        f"images/s at {100 * predict_runs['predict']['busy_share']:.1f}% "
        f"busy; serve ready in {served['ready_s']:.3f} s, first answer in "
        f"{served['first_response_s']:.3f} s; Bongard adapted "
        f"{bongard_runs['Bongard']['images_per_s']:.3f} images/s at "
        f"{100 * bongard_runs['Bongard']['busy_share']:.1f}% busy; phases "
        f"27-30 took {sum(t for _, t in seconds.values()):.1f} s")
    paths = {"main path": main_path, "int8 main path": int8_path,
             "zero-shot": zero_shot, "text-LoRA (per_head)": text_path,
             "prompt tuning (heads)": prompt_path, "CoCoOp": cocoop_path,
             "PLPD": plpd_path, "AugMix": augmix_path,
             "RN50 prompt tuning (heads)": rn50_tpt,
             "RN50 zero-shot": rn50_zero_shot,
             "predict": predict_runs.pop("predict")}
    log("steady samples/s, device busy share, device ms per batch, peak "
        "device memory: "
        + "; ".join(f"{name} {r['samples_per_s']:.3f}, "
                    f"{100 * r['busy_share']:.1f}%, {r['busy_ms']:.1f} ms, "
                    f"{r['peak_gb']:.3f} GB"
                    for name, r in paths.items()))
    paths["TPT on LoRA"] = tpt_lora
    paths["PLPD, int8 prefix"] = plpd_int8
    paths.update(checkpoints)
    paths.update(predict_runs)
    paths.update(bongard_runs)

    def by_path(key):
        return {name: r["launches"][key] for name, r in paths.items()}

    src = "ttl_tpu_torch/csrc/attention_bshd.cu"
    bhsd_src = "ttl_tpu_torch/csrc/attention_bhsd.cu"
    fc1 = k5[K5_FC1]
    k6_fc1 = k6[K6_FC1]

    def other_shapes(kind):
        """K1's or K2's results at OTHER_FWD / OTHER_BWD, by shape."""
        return {f"[{b}, {s}, {w}] {d}": other[(kind, s, d)]
                for b, s, _, _, w, d in (OTHER_FWD if kind == "fwd"
                                         else OTHER_BWD)}

    def bhsd_kernel(name, replaces, results, which, path, key):
        """K3/K4's line: the numbers at the vision shape, the launches of
        the path that runs the kernel, every shape under `shapes`."""
        at_vision = next(iter(results.values()))[which]
        return {"name": name, "route": "cuda", "source": bhsd_src,
                "replaces": replaces, "launches": path["launches"][key],
                **at_vision, "launches_by_path": by_path(key),
                "shapes": {shape: r[which] for shape, r in results.items()}}

    kernels = [
        {"name": "bshd_attention_fwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:431",
         "launches": main_path["launches"]["K1"], **fwd,
         "library_ms": lib_k1,
         "launches_by_path": by_path("K1"),
         "shapes": other_shapes("fwd")},
        {"name": "bshd_attention_bwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:482",
         "launches": main_path["launches"]["K2"], **bwd,
         "library_ms": lib_k2,
         "launches_by_path": by_path("K2"),
         "shapes": other_shapes("bwd")},
        bhsd_kernel("per_head_attention_fwd", "ttl_tpu/ops/attention.py:152",
                    k3, "fwd", text_path, "K3 fwd"),
        bhsd_kernel("per_head_attention_bwd", "ttl_tpu/ops/attention.py:200",
                    k3, "bwd", text_path, "K3 bwd"),
        bhsd_kernel("heads_attention_fwd", "ttl_tpu/ops/attention.py:285",
                    k4, "fwd", prompt_path, "K4 fwd"),
        bhsd_kernel("heads_attention_bwd", "ttl_tpu/ops/attention.py:308",
                    k4, "bwd", prompt_path, "K4 bwd"),
        {"name": "quant_matmul", "route": "cuda",
         "source": "ttl_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "ttl_tpu/ops/quant_matmul.py:42",
         "launches": int8_path["launches"]["K5"],
         "max_abs_err": max(r["max_abs_err"] for r in k5.values()),
         "ms": fc1["ms"], "plain_ms": fc1["plain_ms"],
         "bound_ms": fc1["bound_ms"], "bound_by": fc1["bound_by"],
         "library_ms": fc1["linear_ms"], "int_mm_ms": fc1["int_mm_ms"],
         "launch_ms": fc1["launch_ms"],
         "launches_by_path": by_path("K5"),
         "shapes": {f"[{t}, {k}] x [{k}, {n}] {d}": r
                    for (t, k, n, d), r in k5.items()}},
        {"name": "ln_matmul", "route": "cuda",
         "source": "ttl_tpu_torch/csrc/ln_matmul.cu",
         "replaces": "ttl_tpu/ops/ln_matmul.py:38",
         "launches": cocoop_path["launches"]["K6"],
         **{**k6_fc1,
            "max_abs_err": max(r["max_abs_err"] for r in k6.values())},
         "launches_by_path": by_path("K6"),
         "shapes": {f"[{m}, {k}] x [{k}, {n}] {d}": r
                    for (m, k, n, d), r in k6.items()}},
    ]
    print(json.dumps({"kernels": kernels}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
