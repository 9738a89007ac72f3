"""Smoke run of the PyTorch port (ttl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, side by side), then:

1. prints the card (torch, and nvidia-smi's name and power limit);
2. K1, the bshd attention forward, against its plain PyTorch version at the
   main-path shapes, with max error and median times (CUDA events);
3. K2, the bshd attention backward, against autograd through the plain
   version, likewise;
4. the main path: `ttl_tpu_torch.runner.run` at ViT-B/16 on test set A
   (200 classes) with every other flag at its default, over 16 synthetic
   images of mixed sizes and random weights made from a seed. It checks
   that K1 ran 15 and K2 3 times per batch, that the logits are finite and
   that top-1/top-5 lie in [0, 100]. It then prints the steady-state wall
   samples/s of a longer run (80 images, the runner's own pipeline) and the
   device busy time and top CUDA kernels of one batch (torch.profiler);
5. card against CPU: one sample's adapted logits through the CUDA path and
   through the plain path on the CPU, same weights and view draws;
6. K1/K2 at the geometries the key-tiled route serves (ViT-L/14@336px's
   592 tokens in bf16 and f32, ViT-L/14's 272 in the f32 backward) against
   their plain versions, and the route each geometry takes (ViT-B/16's 208
   keeps the tensor-core kernels);
7. K5, the int8 linear, against `linear_q_plain` on the card at the main
   path's shapes (bit for bit), with the bf16 `linear` it replaces timed
   beside it;
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
   tensors and mask timed beside it as a yardstick (no path uses it);
12. K4, the heads attention, likewise;
13. the K1/K2 yardstick: `scaled_dot_product_attention` forward and backward
   at [512, 208, 768] bf16 with the 197-key mask;
14. `--lora_encoder text` under TTL_FUSED_ATTENTION=per_head through
   `runner.run`: both towers through K3 (36 forward and 3 backward launches
   per batch, K1/K2/K4/K5 none);
15. `--lora_encoder prompt` (TPT) under TTL_FUSED_ATTENTION=heads: K4, 60
   forward and 12 backward launches per batch (every text layer
   checkpointed), with the run's peak device memory;
16. `deyo_selection=False` (TPT on LoRA) on the default route, a short run:
   18 K1 and 3 K2 launches per batch;
17. card against CPU for one sample of phases 14 and 15, the CPU on the
   plain versions under the same route;
18. K6, layernorm folded into the linear behind it, against
   `ln_matmul_plain` on the card at the CoCoOp path's shapes
   ([106496, 768] x [768, 768] and x [768, 3072] bf16), the text width, one
   f32 shape and a ragged M with rows of zeros, with `F.layer_norm` followed
   by `F.linear` (a pair of library calls, on no path) and the package's own
   `layer_norm` + `linear` timed beside it;
19. `--cocoop` on the default route through `runner.run`: the frozen vision
   tower over all 12 layers and 64 views through K6 (48 launches per batch)
   and K1 (12), no other kernel;
20. card against CPU for one CoCoOp sample, `logits` and `adapted_logits`;
21. `--cocoop --load FILE` with a CoCoOp checkpoint the script writes itself
   (a ctx and a meta-net from a seeded generator): one batch with it and one
   without must give different logits.

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
import statistics
import subprocess
import sys
import time

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
# The key-tiled geometries: (batch, padded tokens, true tokens, dtype)
TILED_FWD = [(16, 592, 577, torch.bfloat16), (16, 592, 577, torch.float32)]
TILED_BWD = TILED_FWD + [(16, 272, 257, torch.float32)]
L_HEADS, L_WIDTH = 16, 1024
# K5 at the main path's shapes: T = 512 views x 208 tokens
K5_ROWS = 512 * SEQ_PAD
K5_SHAPES = [(768, 768, torch.bfloat16), (768, 3072, torch.bfloat16),
             (3072, 768, torch.bfloat16), (768, 768, torch.float32)]
# card (bf16, kernels, cuBLAS) against CPU (bf16, plain version): both round
# every activation to bf16 but accumulate in different orders through 12
# layers, a backward and an AdamW step. Logits are 100 x a cosine; with
# random weights |logits| < 2, where one bf16 ulp is 2^-7 = 0.0078, and the
# bound is about 6 such ulps.
CARD_CPU_BOUND = 0.05
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
# K6 at the CoCoOp path's shapes (8 samples x 64 views x 208 tokens), the text
# tower's width (1600 prompts x 32 tokens), one f32 shape, and a ragged M
# (prime, so a multiple of no row tile) with rows of zeros: (M, K, N, dtype)
K6_ROWS = 512 * SEQ_PAD
K6_SHAPES = [(K6_ROWS, 768, 768, torch.bfloat16),
             (K6_ROWS, 768, 3072, torch.bfloat16),
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
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"K2 {name} is not finite")
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
    log(f"K2 [{b}, {s}, {width}] {dtype} ({route}): "
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


def phase_bshd_yardstick() -> tuple:
    """`scaled_dot_product_attention` at K1/K2's main-path shape, heads as
    strided views of the [B, S, H*D] tensors, keys past 197 masked."""
    q, k, v, do = (t.unflatten(-1, (HEADS, -1)).transpose(1, 2)
                   for t in inputs(512, torch.bfloat16, 4, seed=13))
    mask = (torch.arange(SEQ_PAD, device="cuda") < SEQ)[None, None, None]
    fwd, bwd = sdpa_ms(q, k, v, do, mask=mask)
    log(f"scaled_dot_product_attention [512, {SEQ_PAD}, {WIDTH}] bf16, "
        f"{SEQ}-key mask: forward {fwd:.4f} ms, backward {bwd:.4f} ms")
    return fwd, bwd


def phase_bhsd(fa, route: str, label: str) -> dict:
    """K3 (`route` per_head) or K4 (heads), forward and backward, against
    the plain version and autograd through it at BHSD_SHAPES. Returns the
    forward and the backward results at each shape."""
    forward = getattr(fa, f"{route}_forward_cuda")
    backward = getattr(fa, f"{route}_backward_cuda")
    results = {}
    for b, h, s, d, causal, dtype in BHSD_SHAPES:
        g = torch.Generator().manual_seed(SEED + s)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                       for _ in range(4))
        shape = f"[{b}, {h}, {s}, {d}] {dtype}, causal={causal}"
        out = forward(q, k, v, causal)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa.attention_bhsd_plain(*leaves, causal)
        want = torch.autograd.grad(ref, leaves, do, retain_graph=True)
        got = backward(q, k, v, do, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        limit = FWD_BOUND[dtype] * max(1.0, ref.float().abs().max().item())
        if not torch.isfinite(out).all() or not err <= limit:
            raise AssertionError(f"{label} forward at {shape} disagrees with "
                                 f"its plain version: {err} > {limit}")
        worst = 0.0
        for name, gk, w in zip(("dq", "dk", "dv"), got, want):
            e = (gk.float() - w.float()).abs().max().item()
            lim = BWD_BOUND_REL[dtype] * w.float().abs().max().item()
            if not torch.isfinite(gk).all() or not e <= lim:
                raise AssertionError(f"{label} backward {name} at {shape} "
                                     f"disagrees with autograd through the "
                                     f"plain version: {e} > {lim}")
            worst = max(worst, e)
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
            log(f"{label} {kind} {shape}: max_abs_err {r['max_abs_err']:.3e},"
                f" kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"scaled_dot_product_attention {r['library_ms']:.4f} ms")
        results[shape] = {"fwd": fwd, "bwd": bwd}
        del q, k, v, do, out, ref, want, got, leaves
    return results


def phase_forward(fa) -> dict:
    results = {}
    for b, dtype in [(512, torch.bfloat16), (8, torch.bfloat16),
                     (8, torch.float32)]:
        results[(b, dtype)] = check_forward(fa, b, SEQ_PAD, SEQ, HEADS, WIDTH,
                                            dtype, seed=b)
    return results[(512, torch.bfloat16)]


def phase_backward(fa) -> dict:
    return check_backward(fa, 512, SEQ_PAD, SEQ, HEADS, WIDTH,
                          torch.bfloat16, seed=7)


def expect_route(fa, backward: bool, dtype, s: int, d: int, want: str):
    route = fa.kernel_route(backward, dtype, s, d)
    if route != want:
        raise AssertionError(f"{'K2' if backward else 'K1'} at {s} keys, "
                             f"{dtype}: the {route} route, not {want}")


def phase_key_tiled(fa) -> dict:
    """K1/K2 where the key-tiled route runs; ViT-B/16 keeps its routes."""
    for backward in (False, True):
        expect_route(fa, backward, torch.bfloat16, SEQ_PAD, WIDTH // HEADS,
                     "tensor cores")
    out = {}
    for b, s, seq_len, dtype in TILED_FWD:
        expect_route(fa, False, dtype, s, L_WIDTH // L_HEADS,
                     "key-tiled FMA")
        out[("fwd", s, dtype)] = check_forward(fa, b, s, seq_len, L_HEADS,
                                               L_WIDTH, dtype, seed=s)
    for b, s, seq_len, dtype in TILED_BWD:
        expect_route(fa, True, dtype, s, L_WIDTH // L_HEADS, "key-tiled FMA")
        out[("bwd", s, dtype)] = check_backward(fa, b, s, seq_len, L_HEADS,
                                                L_WIDTH, dtype, seed=s + 1)
    return out


def phase_k5(tq) -> dict:
    """K5 against linear_q_plain on the card (bit for bit) and the bf16
    linear it replaces, at the main path's shapes."""
    from ttl_tpu_torch.models.clip import linear
    g = torch.Generator().manual_seed(SEED + 5)
    results = {}
    for k, n, dtype in K5_SHAPES:
        x = torch.randn(K5_ROWS, k, generator=g).to("cuda", dtype)
        p = {"w": (torch.randn(k, n, generator=g) * 0.02).cuda(),
             "b": (torch.randn(n, generator=g) * 0.02).cuda()}
        pq = tq.quantize_linear(p)
        got = tq.linear_q(x, pq)
        want = tq.linear_q_plain(x, pq)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = median_ms(lambda: tq.linear_q(x, pq))
        plain_ms = median_ms(lambda: tq.linear_q_plain(x, pq), reps=5)
        pf = {name: t.to(dtype) for name, t in p.items()}
        linear_ms = median_ms(lambda: linear(x, pf))
        log(f"K5 [{K5_ROWS}, {k}] x [{k}, {n}] {dtype}: max_abs_err {err} "
            f"(bound 0), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{dtype} linear {linear_ms:.4f} ms")
        if err != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"K5 differs from linear_q_plain: {err}")
        itemsize = x.element_size()
        results[(k, n, dtype)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "linear_ms": linear_ms,
            # x read, wq (int8) with its f32 column scales and bias read,
            # y written; 2*T*K*N int8 operations
            **bound(K5_ROWS * (k + n) * itemsize + k * n + 8 * n,
                    2 * K5_ROWS * k * n, torch.int8)}
        del x, got, want
    return results


def phase_k6(tlm) -> dict:
    """K6 against ln_matmul_plain on the card at K6_SHAPES, with the pair of
    library calls that computes the same function (F.layer_norm, F.linear;
    w transposed to F.linear's layout outside the timing) and the package's
    own layer_norm + linear, the pair K6 stands in for, timed beside it."""
    from ttl_tpu_torch.models.clip import layer_norm, linear
    F = torch.nn.functional
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
            "library_ms": library_ms, "port_pair_ms": pair_ms}
        r = results[(m, k, n, dtype)]
        log(f"K6 {shape}{' (rows of zeros)' if ragged else ''}: max_abs_err "
            f"{err:.3e} (bound {limit:.3e}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), F.layer_norm + F.linear {library_ms:.4f} ms, "
            f"the package's layer_norm + linear {pair_ms:.4f} ms")
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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = step_fn(*args)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        # device events only: a CPU op's device time repeats its kernels'
        self.busy_ms = sum(e.self_device_time_total for e in avg
                           if e.device_type == DeviceType.CUDA) / 1e3
        self.table = avg.table(sort_by="self_cuda_time_total", row_limit=15,
                               max_name_column_width=60)
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
            "busy_share": busy_s / np.median(pace), "peak_gb": peak_gb}


def sample_step(cfg, image_seed: int = SEED + 1):
    """run_on(device) -> one fixed sample's logits through `cfg`'s path,
    with weights made on the card and moved to `device`; for CoCoOp a
    [2, C] tensor, `logits` above `adapted_logits`. `image_seed` makes the
    sample's pixels."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt.ttl import (make_fused_cocoop_fn,
                                         make_fused_tpt_fn,
                                         make_fused_ttl_fn,
                                         make_fused_zeroshot_fn)
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.models.clip import tree_map
    from ttl_tpu_torch.models.prompts import prompt_tokens
    from ttl_tpu_torch.ops.image import draw_batch

    dev = torch.device("cuda")
    clip_cfg, params = runner.load_model(cfg, dev)
    rng = np.random.default_rng(image_seed)
    canvas = np.zeros((1, 256, 256, 3), np.uint8)
    canvas[0, :200, :256] = rng.integers(0, 256, (200, 256, 3),
                                         dtype=np.uint8)
    host = {"canvases": torch.from_numpy(canvas),
            "hs": torch.tensor([200]), "ws": torch.tensor([256])}
    draws = draw_batch(cfg.seed, [3], cfg.batch_size)

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

    def run_on(device):
        return step(lambda t: t.to(device))[0].float().cpu()

    return run_on


def card_and_cpu(cfg, **sample):
    """One sample through the CUDA path and through the plain path on the
    CPU, same weights (made, and quantised, on the card) and view draws:
    (card logits, CPU logits, CPU seconds)."""
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


def phase_card_vs_cpu(cfg, name: str):
    """Card against CPU within CARD_CPU_BOUND; returns (card, CPU) logits."""
    card, cpu, cpu_s = card_and_cpu(cfg)
    expect_close(name, card, cpu, CARD_CPU_BOUND, cpu_s)
    return card, cpu


def phase_cocoop_card_vs_cpu(cfg) -> None:
    """CoCoOp, card against CPU within CARD_CPU_BOUND, for `logits` (the
    clean view under its own unadapted ctx: the runner's result) and for
    `adapted_logits` (the clean view under the ctx the step tuned, which
    the 63 random views, the backward and AdamW reach)."""
    card, cpu, cpu_s = card_and_cpu(cfg, image_seed=COCOOP_IMAGE_SEED)
    for row, name in enumerate(("logits", "adapted_logits")):
        expect_close(f"CoCoOp {name}", card[row], cpu[row], CARD_CPU_BOUND,
                     cpu_s)


def phase_int8_card_vs_cpu(name: str, flags: tuple, fp) -> None:
    """The path `flags` with the int8 prefix, card against CPU, within
    CARD_CPU_BOUND plus the CPU's int8 effect; the spread of the int8 effect
    on the card must match the CPU's (EFFECT_SPREAD). `fp`: the (card, CPU)
    logits of the path without the int8 prefix."""
    card, cpu, cpu_s = card_and_cpu(config(*flags, "--prefix_quant", "int8"))
    on_card, on_cpu = card - fp[0], cpu - fp[1]
    ratio = on_card.std().item() / on_cpu.std().item()
    log(f"{name}, int8 effect: max {on_card.abs().max().item():.3e} on the "
        f"card, {on_cpu.abs().max().item():.3e} on the CPU; spread over the "
        f"classes {on_card.std().item():.3e} on the card, "
        f"{on_cpu.std().item():.3e} on the CPU, ratio {ratio:.4f} (within "
        f"{EFFECT_SPREAD})")
    expect_close(name, card, cpu,
                 CARD_CPU_BOUND + on_cpu.abs().max().item(), cpu_s)
    if not EFFECT_SPREAD[0] <= ratio <= EFFECT_SPREAD[1]:
        raise AssertionError(f"{name}: the int8 effect on the card does not "
                             f"match the CPU's (spread ratio {ratio})")


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

    fwd = phase_forward(fa)
    bwd = phase_backward(fa)
    main_path = phase_path(fa, tq, "main path", config(),
                           {"K1": 15, "K2": 3, "K5": 0})
    main_fp = phase_card_vs_cpu(config(), "main path")
    tiled = phase_key_tiled(fa)
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
    lib_k1, lib_k2 = phase_bshd_yardstick()
    text_cfg = config("--lora_encoder", "text")
    prompt_cfg = config("--lora_encoder", "prompt")
    with attention_route(fa, "per_head"):
        text_path = phase_path(fa, tq, "text-LoRA, per_head route", text_cfg,
                               {"K3 fwd": 36, "K3 bwd": 3})
        phase_card_vs_cpu(text_cfg, "text-LoRA, per_head route")
    with attention_route(fa, "heads"):
        prompt_path = phase_path(fa, tq, "prompt tuning, heads route",
                                 prompt_cfg, {"K4 fwd": 60, "K4 bwd": 12})
        phase_card_vs_cpu(prompt_cfg, "prompt tuning, heads route")
    tpt_lora = phase_path(
        fa, tq, "TPT on LoRA",
        config("--deyo_selection", "False"),
        {"K1": 18, "K2": 3}, timed=False)
    k6 = phase_k6(tlm)
    cocoop_cfg = config("--cocoop")
    cocoop_path = phase_path(fa, tq, "CoCoOp", cocoop_cfg,
                             {"K1": 12, "K6": 48})
    phase_cocoop_card_vs_cpu(cocoop_cfg)
    phase_cocoop_load(lib.parent)
    paths = {"main path": main_path, "int8 main path": int8_path,
             "zero-shot": zero_shot, "text-LoRA (per_head)": text_path,
             "prompt tuning (heads)": prompt_path, "CoCoOp": cocoop_path}
    log("steady samples/s, device busy share, peak device memory: "
        + "; ".join(f"{name} {r['samples_per_s']:.3f}, "
                    f"{100 * r['busy_share']:.1f}%, {r['peak_gb']:.3f} GB"
                    for name, r in paths.items()))
    paths["TPT on LoRA"] = tpt_lora

    def by_path(key):
        return {name: r["launches"][key] for name, r in paths.items()}

    src = "ttl_tpu_torch/csrc/attention_bshd.cu"
    bhsd_src = "ttl_tpu_torch/csrc/attention_bhsd.cu"
    fc1 = k5[(768, 3072, torch.bfloat16)]
    k6_fc1 = k6[(K6_ROWS, 768, 3072, torch.bfloat16)]

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
         "key_tiled": {f"[16, {s}, 1024] {d}": r
                       for (kind_, s, d), r in tiled.items()
                       if kind_ == "fwd"}},
        {"name": "bshd_attention_bwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:482",
         "launches": main_path["launches"]["K2"], **bwd,
         "library_ms": lib_k2,
         "launches_by_path": by_path("K2"),
         "key_tiled": {f"[16, {s}, 1024] {d}": r
                       for (kind_, s, d), r in tiled.items()
                       if kind_ == "bwd"}},
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
         "library_ms": fc1["linear_ms"],
         "launches_by_path": by_path("K5"),
         "shapes": {f"[{K5_ROWS}, {k}] x [{k}, {n}] {d}": r
                    for (k, n, d), r in k5.items()}},
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
