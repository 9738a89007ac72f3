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
   bf16 and f32, ViT-L/14's 272, ViT-B/32's 64 with 50 true tokens, and a
   rank's heads on a model axis of 2: ViT-B/16's 6 at [512, 208, 384],
   ViT-L/14's 8 at [64, 272, 512]) against their plain versions, and the
   route each takes: bf16 the tensor cores at every length, f32 the FMA
   routes;
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
   `ln_matmul_plain` on the card at the prefix's shapes ([106496, 768] x
   [768, 768] and x [768, 3072] bf16 at ViT-B/16, [139264, 1024] x [1024,
   1024] and x [1024, 4096] at ViT-L/14), the text width, one f32 shape and
   a ragged M with rows of zeros, with each epilogue: the f32 one (CoCoOp's)
   with `F.layer_norm` followed by `F.linear` (a pair of library calls, on
   no path) and the package's own `layer_norm` + `linear` timed beside it;
   `linear`'s (with QuickGELU where N = 4K, as at fc1) with the chain it
   stands for on the frozen prefix, `layer_norm` -> `linear` (->
   `quick_gelu`), timed beside it, the outputs that differ from the plain
   version under K6_LINEAR_SHARE; the achieved TFLOP/s; ptxas on its
   kernels (no spills in the wgmma ones); at fc1 two calls on the same
   inputs must give the same bits;
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
   protocol timed and profiled (`tools/torch_kernel_callers.py` names the
   operators that launch its top kernels);
31. `python -m ttl_tpu_torch DATA --test_sets A --profile DIR` through
   `cli.main` over 80 images written in set A's layout: 15 K1 and 3 K2
   launches a batch, one trace in DIR whose `utils.profiling.op_stats` rows
   name K1's and K2's kernels at those launches, the steady samples/s under
   the profiler beside phase 4's, and the device time's sum beside the
   union of its intervals;
32. `utils.analysis` at ViT-B/16 over 2 images: the attention maps on the
   card against the CPU in f32 within ANALYSIS_BOUND, rows summing to 1, the
   rollout and the overlay in [0, 1];
33. data-parallel evaluation, two ranks on cuda:0 (`rank_worker` processes
   of `cli.main(... --test_sets cifar10 --init_distributed --sample_batch
   16 --canvas 32)` over a synthetic CIFAR-10 test batch of 128 images)
   against one process at `--sample_batch 8`: the same top-1/top-5, 15 K1
   and 3 K2 launches a local batch on each rank, the summary on rank 0
   alone, each sample's logits (the runner's, and those gathered by
   `parallel.eval.make_sharded_ttl_fn`) against the single process's, and
   each process's steady s/batch;
34. the model axis, two ranks of one model group on cuda:0 over gloo
   (`rank_worker` processes of `cli.main(... --test_sets A
   --init_distributed --mesh_shape 1,2 --sample_batch 2)` over 12 images in
   set A's layout: 200 classes, so the classifier is split by classes)
   against one process at `--sample_batch 2`: 15 K1 and 3 K2 launches a
   batch on each rank, every K1 at 6 heads, the one process's counts and
   every sample's top-1, the two ranks bit for bit, rank 0's logits and
   first-update gradients within MODEL_AXIS_BOUND_REL of their largest
   element; each rank's steady s/batch and the host ms of its model
   group's collectives a batch (`phase_model_axis(cards=2)` runs it on two
   cards over NCCL);
35. serving over two ranks on cuda:0: `python -m ttl_tpu_torch.serve
   --test_sets I --sample_batch 2 --mesh_shape 2`, then `1,2`, two
   processes each as torch.distributed.run starts them; a burst of 8 PNGs
   against the one-process predictor's answers (labels, zero-shot labels,
   top-5 probabilities within MODEL_AXIS_BOUND_REL["logits"]), then
   SIGTERM: rank 0 drains, both exit 0;
36. the tools: `tools/torch_quant_fidelity.py --samples 16` at ViT-B/16
   (its JSON line), and `tools/torch_convert_checkpoint.py` on phase 26's
   seeded RN50 `.pt`: the `.npz` holds the checkpoint's leaves bit for bit.
37. `python3 bench_torch.py` at its defaults in a process of its own: its
   one JSON line echoed, a rate, the H100's name, every stage (the
   headline's busy rate, 1000 classes, the int8 prefix) and the launches a
   step of each (K1 15, K2 3; K5 54 in the int8 stage);
38. `tools/torch_bench_arches.py --rows ViT-B/32` (wall and busy rates, 15
   K1 and 3 K2 a step) and `tools/torch_bench_host_loader.py --n 256`
   (PIL's host rate, and the native decoder's where it loads);
39. `bench_torch.py` as two processes on cuda:0 over gloo (RANK 0 and 1,
   WORLD_SIZE 2, LOCAL_RANK 0, TTL_BENCH_S=2): the aggregate stage, rank 0
   alone printing, with the aggregate's launches;
40. the SwiGLU kernels of the EVA02 tower (`ops/swiglu.py`,
   `csrc/swiglu.cu`), forward and backward, against their plain versions on
   the card at SWIGLU_SHAPES (the EVA02-L/14@336 step's [512 x 592, 2 x
   2730] and [8 x 592, 2 x 2730] bf16, an odd width, f32), within
   SWIGLU_BOUND of each output with under SWIGLU_SHARE of the bf16 ones
   differing,
   the same bits from a second call, a launch counted each; ptxas on its
   kernels (no spills); at the step's shape the median times beside the
   plain versions' and the bound (bytes over 3.35 TB/s);
41. the layernorm kernels (`ops/layer_norm.py`, `csrc/layer_norm.cu`),
   forward and dx backward, at LN_SHAPES (EVA02-L/14@336's step at 2730 and
   1024, ViT-B/16's window at 768, all bf16; a ragged row count at 512; f32
   at 2730): the forward against the plain version within LN_BOUND with
   under LN_SHARE of the bf16 outputs differing, dx against autograd through
   the plain version within LN_BWD_BOUND, the same bits from a second call,
   a launch counted each way; ptxas on its kernels (no spills); at the step
   shapes the median times beside the plain versions', `F.layer_norm`'s (a
   library call on no path) and the bound (bytes over 3.35 TB/s); the
   forward and dx under TTL_LN_STATS=ex2 against the plain version's ex2 at
   LN_EX2_SHAPE. Every path that `phase_path` runs checks its layernorm
   launches over its 16-image run (`layer_norm` in its result): the class
   table's text tower once, where the path encodes one, and a count a
   batch;
42. EVA02's MLP at the stride the card stores it on (`models/eva02.py::
   card_layout`, 2730 -> 2736 columns): the four products of the
   eva02l14-336-offline step's SwiGLU MLPs at its MLP_ROWS rows, h @ w12 +
   b, s @ w3 + b, dY @ w3^T and d[u|g] @ w12^T, each at F = 2730 and at
   2736 with zero padding, their median times, TFLOP/s at the true width's
   operations and the device kernel cuBLAS ran (torch.profiler); the padded
   products' true columns against the unpadded ones' within MLP_BOUND; then
   LN_ffn's kernel on the 2736-wide rows at the logical width 2730, forward
   and dx, against the plain version as phase 41 holds it (the padding
   filled with values it must not read, y and dx exactly 0 past 2730, a
   launch and a strided launch counted each way), its median times beside
   the unmasked kernel's at 2730;
43. AIMv2-L/14's kernels (`models/aimv2.py`): ptxas on K1/K2's head-dim-128
   instances, the RMS layernorm kernels and K6's RMS instances; K1/K2 at
   [512, 256, 1024] bf16, 8 heads of 128, against the plain version within
   FWD_BOUND and BWD_BOUND_REL, with the median times beside the bound and
   beside 16 heads of 64 at the same shape; the RMS layernorm forward and
   dx at [131072, 1024] bf16 against the plain version as phase 41 holds
   the layernorm (an RMS launch counted each way), timed beside the
   centered kernel, and at the text tower's [77000, 768] (the class table of
   1000 classes, another instance of the kernels) as phase 41 holds it; K6
   with the RMS statistics at [131072, 1024] x [1024,
   N], N = 3072 (RMSNorm_1 -> qkv) and 5632 (RMSNorm_2 -> [Wg | Wu]),
   against the plain version as phase 20 holds K6's `linear` epilogue,
   timed beside the unfolded rms_norm -> linear and the centered K6; the
   SwiGLU kernels at AIM_SWIGLU_SHAPES (F = 2816 at the prefix's
   [131072, 2 x 2816] and the clean pass's [2048, 2 x 2816] bf16) as phase
   40 holds them, timed at the prefix's; then
   the AIMv2 path, `--arch AIMv2-L-14-224-LiT` through `runner.run` as
   phase 4 drives ViT-B/16 (K1 27, K2 3, K6 and its RMS launches 42 a
   batch; the text tower's 25 norms once and 21 a batch, every one of them
   an RMS launch). Every other path's K6 RMS and RMS layernorm launches are
   0, asserted with its counts.

K6 with `linear`'s epilogue ("K6 linear" in the launch counts, which "K6"
counts too) runs q, k, v and fc1 of every full-precision vision layer that
`vision_prefix` runs without gradient: 36 launches a batch on ViT-B/16's
adapted paths (the 9-layer prefix; 72 with PLPD's counterfactual), 48 where
the whole tower runs so (text-LoRA, TPT, zero-shot without int8, `--tta_steps
0`), none over int8 layers, a ResNet or CoCoOp's tower (the f32 epilogue).
The launch counts above name K1-K5; each phase also checks K6's.

Every device time comes from `ttl_tpu_torch/utils/profiling.py`'s reading
of a torch.profiler trace (`profiled`), the reader `--profile` uses.

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
# tokens, heads, width, dtype): ViT-L/14@336px, ViT-L/14, ViT-B/32, and a
# rank's heads on a model axis of 2 (phase 34): ViT-B/16's 6, ViT-L/14's 8
OTHER_FWD = [(16, 592, 577, 16, 1024, torch.bfloat16),
             (16, 592, 577, 16, 1024, torch.float32),
             (64, 272, 257, 16, 1024, torch.bfloat16),
             (512, 64, 50, 12, 768, torch.bfloat16),
             (512, 208, 197, 6, 384, torch.bfloat16),
             (64, 272, 257, 8, 512, torch.bfloat16)]
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
# Phase 34, the model axis (two ranks of one model group) against one
# process, both bf16 on the card: the rank sums o's and fc2's partial
# products in f32 and rounds once, where one card's GEMM accumulates them in
# f32 in another order and rounds once, so an activation may round one bf16
# step the other way, and that spreads through the layers and AdamW's step.
# Each bound, relative to the largest element, is twice the largest
# difference that tools/torch_card_cpu_noise.py --model_axis measured over
# image seeds 92-99, rounded up to a power of two (H100 80GB HBM3, 700 W;
# PERF.md). The logits come after AdamW's lr * sign(g) step, which turns
# gradient elements near 0 the other way, so they spread wider.
MODEL_AXIS_BOUND_REL = {"logits": 2.0 ** -5,      # largest 1.38e-2
                        "gradient": 2.0 ** -7}    # largest 2.20e-3
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
             (10007, 768, 3072, torch.bfloat16),
             # ViT-L/14's prefix: 512 views of 272 padded tokens, 64-row tiles
             (512 * 272, 1024, 1024, torch.bfloat16),
             (512 * 272, 1024, 4096, torch.bfloat16)]
# K6 vs plain. bf16: both round the normalised row and the output once, but
# the statistics and the product sum in another order, so a normalised value
# or an output may round the other way: one bf16 step of the output, which
# at the top of its range is at most 2^-7 of the largest output. f32: the
# order of the sums only, 1e-5 of the output's scale.
K6_BOUND = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
# K6 with `linear`'s epilogue vs plain: the same rounding points, so an
# output differs only where the order of the sums moved a value across a
# rounding boundary (2e-4 of them at the prefix's shapes on an H100);
# the f32 epilogue's single rounding moves about a quarter
K6_LINEAR_SHARE = 0.01
# SwiGLU: (rows, F, dtype). The EVA02-L/14@336 step's prefix (512 views of
# 592 padded tokens) and clean passes (8 of 592), an odd F (the scalar
# kernel), f32.
SWIGLU_STEP = (512 * 592, 2730, torch.bfloat16)
SWIGLU_SHAPES = [SWIGLU_STEP, (8 * 592, 2730, torch.bfloat16),
                 (1001, 85, torch.bfloat16), (4096, 2730, torch.float32)]
# SwiGLU vs plain: both compute each output in f32 and round it once; the
# kernel's fast exponential and reciprocal move the f32 value by a few units
# in its last place, so a bf16 output may round the other way: one bf16 step
# of the output (2^-7 of its magnitude at most) plus, for the backward's du,
# whose (1 + u (1 - sig)) cancels near u = -1.28, 2^-16 of the largest
# output; f32, 1e-5 of the output's magnitude plus 1e-6 of the largest
SWIGLU_BOUND = {torch.bfloat16: (2.0 ** -7, 2.0 ** -16),
                torch.float32: (1e-5, 1e-6)}
# the share of bf16 outputs the rounding may move (f32 outputs all may move)
SWIGLU_SHARE = {torch.bfloat16: 0.01, torch.float32: 1.0}
# The layernorm kernels: (rows, K, dtype). EVA02-L/14@336's step (512 views
# of 592 padded tokens) at LN_ffn's width and at the tower's, ViT-B/16's
# window (512 views of 208), then a row count that fills no block of four
# warp rows, and f32 at the block route's width.
LN_STEP_SHAPES = [(512 * 592, 2730, torch.bfloat16),
                  (512 * 592, 1024, torch.bfloat16),
                  (512 * SEQ_PAD, 768, torch.bfloat16)]
LN_SHAPES = LN_STEP_SHAPES + [(1001, 512, torch.bfloat16),
                              (4099, 2730, torch.float32)]
# Layernorm vs plain: both round the same f32 value once, but the statistics
# sum in another order, so a bf16 output may round one step (2^-7 of it) the
# other way, plus 2^-16 of the largest where the affine's add cancels; f32,
# the order of the sums, 1e-5 of the largest. dx likewise, with 2^-12 of the
# largest where g - mean(g) - xh mean(g xh) cancels.
LN_BOUND = {torch.bfloat16: (2.0 ** -7, 2.0 ** -16),
            torch.float32: (0.0, 1e-5)}
LN_BWD_BOUND = {torch.bfloat16: (2.0 ** -7, 2.0 ** -12),
                torch.float32: (0.0, 1e-5)}
# the share of bf16 forward outputs the order of the sums may move
LN_SHARE = {torch.bfloat16: 0.01, torch.float32: 1.0}
# layernorm launches of a path's run, (once, a batch of 8): LN_TEXT the
# class table's text tower once (12 layers x 2 and ln_final, at ViT-B/16's
# and RN50's towers); LN_MAIN a main-path batch at ViT-B/16, window 9-11:
# ln_pre (the prefix folds into K6), the window's 6 and ln_post forward,
# their backward but layer 9's ln1, the clean-view pass's 7. A zero-shot
# pass over the tower K6 folds adds ln_pre and ln_post, one over the int8
# prefix 24 more (ln1 and ln2 of 12 layers); an unfolded 9-layer prefix 18.
# Prompt tuning, text-LoRA and CoCoOp encode the class text in each batch,
# and nothing once.
LN_TEXT = 25
LN_MAIN = 21
# the shape the ex2 statistics are checked at
LN_EX2_SHAPE = (2 * 592 + 1, 2730, torch.bfloat16)
# EVA02-L/14@336's MLP (phase 42): the step's rows (512 views of 592 padded
# tokens), its width D, its SwiGLU width F and the width the card stores F at
MLP_ROWS = 512 * 592
MLP_D, MLP_F, MLP_FP = 1024, 2730, 2736
# a padded product's true columns against the unpadded product's: f32 sums
# over the same terms (plus zeros) in another order, rounded to bf16 and,
# in `linear`, rounded again after the bias add: one bf16 step of the
# output (2^-7 of it) at each rounding, plus 2^-12 of the largest where the
# bias add cancels
MLP_BOUND = (2.0 ** -6, 2.0 ** -12)
# AIMv2-L/14's step (phase 43): 8 images x 64 views of 256 tokens (no class
# token), width 1024 in 8 heads of 128; the prefix folds RMSNorm_1 -> qkv
# and RMSNorm_2 -> [Wg | Wu] into K6
AIM_ROWS = 512 * 256
AIM_D, AIM_HEADS, AIM_HD = 1024, 8, 128
AIM_K6_N = (3072, 5632)
# its SwiGLU (F = 2816, bias-free) at the prefix's rows and the clean pass's
# (8 views of 256), and the text tower's RMS width over the class table's
# rows (1000 classes of 77 tokens)
AIM_SWIGLU_SHAPES = [(AIM_ROWS, 2816, torch.bfloat16),
                     (8 * 256, 2816, torch.bfloat16)]
AIM_TEXT_ROWS, AIM_TEXT_D = 1000 * 77, 768
# the AIMv2 path's launches a batch of 8 (the main path, no zero-shot aux
# pass): K1 in the 24 layers and the clean view's 3, K2 in the window, K6
# twice in each of the 21 prefix layers, all with the RMS statistics
AIM_PATH = {"K1": 27, "K2": 3, "K6": 42, "K6 linear": 42, "K6 RMS": 42}
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
    ViT-L/14@336px's and a model-axis rank's 6 heads, whose bf16 entries of
    `other` it completes."""
    for b, s, seq_len, heads, width, _ in (OTHER_FWD[0], OTHER_FWD[4]):
        fwd, bwd = bshd_yardstick(b, s, seq_len, heads, width)
        other[("fwd", s, width, torch.bfloat16)]["library_ms"] = fwd
        other[("bwd", s, width, torch.bfloat16)]["library_ms"] = bwd
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
        out[("fwd", s, width, dtype)] = check_forward(
            fa, b, s, seq_len, heads, width, dtype, seed=s)
    for b, s, seq_len, heads, width, dtype in OTHER_BWD:
        expect_route(fa, True, dtype, s, width // heads)
        out[("bwd", s, width, dtype)] = check_backward(
            fa, b, s, seq_len, heads, width, dtype, seed=s + 1)
    return out


def k5_launch_ms(tq, x, pq, reps: int = 5, tries: int = 3):
    """Device ms of each of K5's launches within one call at x's shape,
    averaged over the launches of `reps` calls, read by `utils.profiling`
    (`trace`, `op_stats`): (Q) `quant_rows`, (W) `transpose_w`, (G) `gemm`.
    A profiler run in a process that has run others may record no kernel at
    all: it is run again, and after `tries` empty runs the result is None."""
    import tempfile
    from ttl_tpu_torch.utils.profiling import op_stats, trace
    tq.linear_q(x, pq)
    torch.cuda.synchronize()
    for _ in range(tries):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp, "cuda"):
                for _ in range(reps):
                    tq.linear_q(x, pq)
            rows = op_stats(tmp, top=10 ** 6)
        out = {}
        for r in rows:
            found = re.search(r"k5_(\w+?)_kernel", r["operation"])
            if found:
                # per launch the profiler kept (it may miss a call's)
                out[found.group(1)] = (r["self_time_us"] / 1e3
                                       / r["occurrences"])
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
            log(f"K5 [{t}, {k}] x [{k}, {n}] per launch (utils.profiling): "
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


def phase_swiglu(tsw) -> dict:
    """The SwiGLU kernels against their plain versions at SWIGLU_SHAPES
    (see the module's phase 40); times at SWIGLU_STEP."""
    from ttl_tpu_torch.ops import _build
    log("ptxas on the SwiGLU kernels (swiglu.cu):")
    for key, used in sorted(_build.kernel_resources("swiglu").items()):
        log(f"  {key.split(': ', 1)[1]}: {used}")
        if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                         used):
            raise AssertionError(f"SwiGLU's {key} spills: {used}")
    g = torch.Generator().manual_seed(SEED + 40)
    results = {}
    for rows, f, dtype in SWIGLU_SHAPES:
        gu = (torch.randn(rows, 2 * f, generator=g) * 3).to("cuda", dtype)
        dy = torch.randn(rows, f, generator=g).to("cuda", dtype)
        results[(rows, f, dtype)] = swiglu_against_plain(
            tsw, gu, dy, timed=(rows, f, dtype) == SWIGLU_STEP)
        del gu, dy
    return results


def swiglu_against_plain(tsw, gu, dy, timed: bool) -> dict:
    """The SwiGLU kernels' forward and backward on gu [rows, 2F] and dy
    [rows, F], a launch counted, against their plain versions within
    SWIGLU_BOUND with under SWIGLU_SHARE of the outputs differing, and the
    same bits from a second call; where `timed`, the median times beside
    the plain versions' and the bound (bytes over 3.35 TB/s)."""
    rows, f, dtype = dy.shape[0], dy.shape[1], dy.dtype
    shape = f"[{rows}, 2 x {f}] {dtype}"
    before = tsw.swiglu.launches
    out = tsw.swiglu(gu)
    grad = tsw.swiglu_grad_cuda(gu, dy)
    torch.cuda.synchronize()
    if tsw.swiglu.launches != before + 1:
        raise AssertionError(f"SwiGLU at {shape}: no launch was counted")
    errs = {}
    for which, got, want in (
            ("fwd", out, tsw.swiglu_plain(gu)),
            ("bwd", grad, tsw.swiglu_grad_plain(gu, dy))):
        rel, floor = SWIGLU_BOUND[dtype]
        got, want = got.float(), want.float()
        err = (got - want).abs()
        limit = rel * want.abs() + floor * want.abs().max()
        share = (err > 0).float().mean().item()
        if not torch.isfinite(got).all() or (err > limit).any() \
                or share > SWIGLU_SHARE[dtype]:
            raise AssertionError(
                f"SwiGLU {which} at {shape} disagrees with its plain "
                f"version: {err.max().item():.3e} at most, "
                f"{(err > limit).sum().item()} outputs past the bound, "
                f"{share:.2e} of them differing")
        errs[which] = (err.max().item(), share)
    if not (torch.equal(out, tsw.swiglu_cuda(gu))
            and torch.equal(grad, tsw.swiglu_grad_cuda(gu, dy))):
        raise AssertionError(f"SwiGLU at {shape}: two calls on the same "
                             "inputs gave different bits")
    r = {"max_abs_err": max(e for e, _ in errs.values()),
         "fwd_differing": errs["fwd"][1], "bwd_differing": errs["bwd"][1]}
    if timed:
        item = gu.element_size()
        r.update(
            ms=median_ms(lambda: tsw.swiglu_cuda(gu)),
            bwd_ms=median_ms(lambda: tsw.swiglu_grad_cuda(gu, dy)),
            plain_ms=median_ms(lambda: tsw.swiglu_plain(gu), reps=5),
            bwd_plain_ms=median_ms(
                lambda: tsw.swiglu_grad_plain(gu, dy), reps=5),
            bound_ms=rows * 3 * f * item / 3.35e9,
            bwd_bound_ms=rows * 5 * f * item / 3.35e9, bound_by="bytes")
    log(f"SwiGLU {shape}: " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in r.items()))
    return r


def ln_inputs(g, rows: int, k: int, dtype):
    """x with an offset a row, scale and bias off 1 and 0 (f32), dy."""
    x = (torch.randn(rows, k, device="cuda", generator=g) * 2
         + torch.randn(rows, 1, device="cuda", generator=g)).to(dtype)
    scale = 1 + 0.3 * torch.randn(k, device="cuda", generator=g)
    bias = 0.3 * torch.randn(k, device="cuda", generator=g)
    dy = torch.randn(rows, k, device="cuda", generator=g).to(dtype)
    return x, scale, bias, dy


def ln_against_plain(tln, x, scale, bias, dy, eps, stats: str,
                     width=None):
    """The layernorm kernels' forward and dx on x, a launch counted each
    (and a strided launch where `width` is below the row), against the
    plain version's and autograd through it within LN_BOUND, LN_SHARE and
    LN_BWD_BOUND: (the errors and differing shares by way, y, dx, the plain
    y and the input leaf)."""
    rows, k = x.shape
    shape = f"[{rows}, {k}] {x.dtype}, {stats}, width {width or k}"
    leaf = x.detach().requires_grad_(True)
    before = tln.layer_norm.launches, tln.layer_norm.strided_launches
    out = tln.layer_norm(leaf, scale, bias, eps, stats, width)
    (grad,) = torch.autograd.grad(out, leaf, dy)
    torch.cuda.synchronize()
    strided = 2 if (width or k) < k else 0
    if (tln.layer_norm.launches, tln.layer_norm.strided_launches) != (
            before[0] + 2, before[1] + strided):
        raise AssertionError(f"layernorm at {shape}: a forward and a "
                             "backward were not counted")
    plain = tln.layer_norm_plain(leaf, scale, bias, eps, stats, width)
    (plain_grad,) = torch.autograd.grad(plain, leaf, dy, retain_graph=True)
    errs = {}
    for which, got, want, (rel, floor), share_bound in (
            ("fwd", out, plain, LN_BOUND[x.dtype], LN_SHARE[x.dtype]),
            ("bwd", grad, plain_grad, LN_BWD_BOUND[x.dtype], 1.0)):
        got, want = got.detach().float(), want.detach().float()
        err = (got - want).abs()
        limit = rel * want.abs() + floor * want.abs().max()
        share = (err > 0).float().mean().item()
        if not torch.isfinite(got).all() or (err > limit).any() \
                or share > share_bound:
            raise AssertionError(
                f"layernorm {which} at {shape} disagrees with the plain "
                f"version: {err.max().item():.3e} at most, "
                f"{(err > limit).sum().item()} outputs past the bound, "
                f"{share:.2e} of them differing")
        errs[which] = (err.max().item(), share)
    return errs, out, grad, plain, leaf


def phase_layer_norm(tln) -> dict:
    """The layernorm kernels against the plain version at LN_SHAPES and,
    with the ex2 statistics, at LN_EX2_SHAPE (see the module's phase 41);
    times at LN_STEP_SHAPES."""
    import torch.nn.functional as F
    from ttl_tpu_torch.ops import _build
    log("ptxas on the layernorm kernels (layer_norm.cu):")
    for key, used in sorted(_build.kernel_resources("layer_norm_").items()):
        log(f"  {key.split(': ', 1)[1]}: {used}")
        if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                         used):
            raise AssertionError(f"layernorm's {key} spills: {used}")
    g = torch.Generator("cuda").manual_seed(SEED + 41)
    eps = 1e-6
    results = {}
    for rows, k, dtype in LN_SHAPES:
        shape = f"[{rows}, {k}] {dtype}"
        x, scale, bias, dy = ln_inputs(g, rows, k, dtype)
        errs, out, grad, plain, leaf = ln_against_plain(
            tln, x, scale, bias, dy, eps, "centered")
        y, mu, rstd = tln.layer_norm_cuda(x, scale, bias, eps,
                                          with_stats=True)
        if not (torch.equal(y, out) and torch.equal(
                grad, tln.layer_norm_grad_cuda(x, dy, scale, mu, rstd))):
            raise AssertionError(f"layernorm at {shape}: two calls on the "
                                 "same inputs gave different bits")
        r = {"max_abs_err": max(e for e, _ in errs.values()),
             "fwd_max_abs_err": errs["fwd"][0],
             "bwd_max_abs_err": errs["bwd"][0],
             "fwd_differing": errs["fwd"][1],
             "bwd_differing": errs["bwd"][1]}
        if (rows, k, dtype) in LN_STEP_SHAPES:
            item = x.element_size()
            lib_scale, lib_bias = scale.to(dtype), bias.to(dtype)
            lib_leaf = x.detach().requires_grad_(True)
            lib_out = F.layer_norm(lib_leaf, (k,), lib_scale, lib_bias, eps)
            r.update(
                ms=median_ms(lambda: tln.layer_norm_cuda(x, scale, bias,
                                                         eps)),
                bwd_ms=median_ms(lambda: tln.layer_norm_grad_cuda(
                    x, dy, scale, mu, rstd)),
                plain_ms=median_ms(lambda: tln.layer_norm_plain(
                    x, scale, bias, eps), reps=5),
                bwd_plain_ms=median_ms(lambda: torch.autograd.grad(
                    plain, leaf, dy, retain_graph=True), reps=5),
                library_ms=median_ms(lambda: F.layer_norm(
                    x, (k,), lib_scale, lib_bias, eps)),
                bwd_library_ms=median_ms(lambda: torch.autograd.grad(
                    lib_out, lib_leaf, dy, retain_graph=True)),
                bound_ms=rows * 2 * k * item / 3.35e9,
                bwd_bound_ms=rows * 3 * k * item / 3.35e9, bound_by="bytes")
            del lib_leaf, lib_out
        log(f"layernorm {shape}: " + ", ".join(
            f"{k_} {v:.4g}" if isinstance(v, float) else f"{k_} {v}"
            for k_, v in r.items()))
        results[(rows, k, dtype)] = r
        del x, dy, leaf, out, grad, plain, y, mu, rstd
        torch.cuda.empty_cache()
    errs = ln_against_plain(tln, *ln_inputs(g, *LN_EX2_SHAPE), eps,
                            "ex2")[0]
    rows, k, dtype = LN_EX2_SHAPE
    log(f"layernorm [{rows}, {k}] {dtype}, ex2: " + ", ".join(
        f"{which} max_abs_err {e:.4g}, differing {share:.4g}"
        for which, (e, share) in errs.items()))
    results[(rows, k, f"{dtype}, ex2")] = {
        "max_abs_err": max(e for e, _ in errs.values()),
        "fwd_max_abs_err": errs["fwd"][0], "bwd_max_abs_err": errs["bwd"][0],
        "fwd_differing": errs["fwd"][1], "bwd_differing": errs["bwd"][1]}
    return results


def mlp_weights(g, padded: bool) -> dict:
    """EVA02-L/14@336's MLP weights of one layer (w12, w3 and their biases,
    bf16, drawn from g), laid out by `models/eva02.py::card_layout` where
    `padded` (W1 | 0 | W2 | 0 and w3's zero rows at 2736 columns)."""
    from ttl_tpu_torch.models.clip import tree_map
    from ttl_tpu_torch.models.eva02 import card_layout
    from ttl_tpu_torch.models.zoo import get_arch
    vcfg = get_arch("EVA02-CLIP-L-14-336").vision
    d, f = MLP_D, MLP_F
    w1, w2, w3 = (0.02 * torch.randn(*shape, device="cuda", generator=g)
                  for shape in ((d, f), (d, f), (f, d)))
    b1, b2, b3 = (0.02 * torch.randn(n, device="cuda", generator=g)
                  for n in (f, f, d))
    layers = {"w12": {"w": torch.cat([w1, w2], -1),
                      "b": torch.cat([b1, b2], -1)},
              "w3": {"w": w3, "b": b3},
              "ln_ffn": {"scale": torch.ones(f, device="cuda"),
                         "bias": torch.zeros(f, device="cuda")}}
    if padded:
        layers = card_layout({"layers": layers}, vcfg)["layers"]
    return tree_map(lambda t: t.to(torch.bfloat16),
                    {"w12": layers["w12"], "w3": layers["w3"]})


def phase_mlp_stride(tln) -> dict:
    """EVA02's MLP products at F = MLP_F and its stored width MLP_FP, and
    LN_ffn's kernel at the logical width (see the module's phase 42)."""
    from ttl_tpu_torch.models.clip import linear
    g = torch.Generator("cuda").manual_seed(SEED + 42)
    rows, d, f = MLP_ROWS, MLP_D, MLP_F
    pad = torch.nn.functional.pad
    h, dy, s0, dgu0 = (torch.randn(rows, n, device="cuda", generator=g).to(
        torch.bfloat16) for n in (d, d, f, 2 * f))
    # the true width's operations: 2 M D 2F for w12's two, 2 M F D for w3's
    flops = {"h @ w12 + b": 4 * rows * d * f, "s @ w3 + b": 2 * rows * f * d,
             "dY @ w3^T": 2 * rows * d * f, "d[u|g] @ w12^T": 4 * rows * f * d}
    results, outs = {}, {}
    for fp in (f, MLP_FP):
        w = mlp_weights(torch.Generator("cuda").manual_seed(SEED + 42),
                        fp != f)
        if w["w3"]["w"].shape[0] != fp:
            raise AssertionError(f"card_layout stored F = {f} at "
                                 f"{w['w3']['w'].shape[0]}, not {fp}")
        # the same hidden and gradient, zero past F in each half
        s_ = pad(s0, (0, fp - f))
        dgu = torch.cat([pad(half, (0, fp - f))
                         for half in dgu0.chunk(2, dim=-1)], -1)
        w12t, w3t = w["w12"]["w"].t(), w["w3"]["w"].t()
        products = {"h @ w12 + b": lambda: linear(h, w["w12"]),
                    "s @ w3 + b": lambda: linear(s_, w["w3"]),
                    "dY @ w3^T": lambda: torch.matmul(dy, w3t),
                    "d[u|g] @ w12^T": lambda: torch.matmul(dgu, w12t)}
        for name, fn in products.items():
            out, _, table = profiled(fn)
            torch.cuda.synchronize()
            ms = median_ms(fn)
            kernel = table.splitlines()[0].split("%  ", 1)[1] if table \
                else "not traced"
            r = {"ms": ms, "tflops": flops[name] / ms / 1e9,
                 "kernel": kernel[:80]}
            results[(name, fp)] = r
            log(f"MLP {name} at F {f} stored at {fp}, [{rows}, ...] bf16: "
                f"{ms:.4f} ms, {r['tflops']:.1f} TFLOP/s, {r['kernel']}")
            # the true columns only: u's and g's halves, or s's F
            if name == "h @ w12 + b":
                out = torch.cat([out[:, :f], out[:, fp:fp + f]], -1)
            elif name == "dY @ w3^T":
                out = out[:, :f]
            if name in outs:
                rel, floor = MLP_BOUND
                want = outs[name].float()
                err = (out.float() - want).abs()
                if (err > rel * want.abs() + floor * want.abs().max()).any():
                    raise AssertionError(
                        f"MLP {name}: the padded product's true columns "
                        f"differ from the unpadded one's by "
                        f"{err.max().item():.3e}")
                results[(name, fp)]["max_abs_err"] = err.max().item()
            else:
                outs[name] = out
            del out
        del w, w12t, w3t, s_, dgu, products
        torch.cuda.empty_cache()
    del h, dy, s0, dgu0, outs
    torch.cuda.empty_cache()
    # LN_ffn: 2736-wide rows normalised over 2730, the padding filled
    x, scale, bias, dy = ln_inputs(torch.Generator("cuda").manual_seed(
        SEED + 43), rows, MLP_FP, torch.bfloat16)
    scale[f:] = 0
    bias[f:] = 0
    errs, out, grad, plain, leaf = ln_against_plain(
        tln, x, scale, bias, dy, 1e-6, "centered", width=f)
    if out[:, f:].any() or grad[:, f:].any():
        raise AssertionError("layernorm at the logical width wrote a "
                             "nonzero past it")
    del out, grad, plain, leaf
    _, mu, rstd = tln.layer_norm_cuda(x, scale, bias, 1e-6, True, width=f)
    narrow, dy_n = x[:, :f].contiguous(), dy[:, :f].contiguous()
    _, mu_n, rstd_n = tln.layer_norm_cuda(narrow, scale[:f], bias[:f], 1e-6,
                                          True)
    ln = {"fwd_max_abs_err": errs["fwd"][0], "bwd_max_abs_err": errs["bwd"][0],
          "fwd_differing": errs["fwd"][1], "bwd_differing": errs["bwd"][1],
          "ms": median_ms(lambda: tln.layer_norm_cuda(x, scale, bias, 1e-6,
                                                      width=f)),
          "bwd_ms": median_ms(lambda: tln.layer_norm_grad_cuda(
              x, dy, scale, mu, rstd, width=f)),
          "unmasked_ms": median_ms(lambda: tln.layer_norm_cuda(
              narrow, scale[:f], bias[:f], 1e-6)),
          "unmasked_bwd_ms": median_ms(lambda: tln.layer_norm_grad_cuda(
              narrow, dy_n, scale[:f], mu_n, rstd_n)),
          "bound_ms": rows * 2 * f * 2 / 3.35e9,
          "bwd_bound_ms": rows * 3 * f * 2 / 3.35e9, "bound_by": "bytes"}
    log(f"layernorm [{rows}, {MLP_FP}] bf16 at width {f}: " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in ln.items()))
    results["layer_norm"] = ln
    return results


def in_turns(fns: dict) -> dict:
    """The least of two median times of each of `fns`, timed in turns (each
    in order, then each in the reverse order), so that the clocks of one
    stretch of the call do not fall on one of them alone."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(median_ms(fns[name]))
    return {name: min(t) for name, t in times.items()}


def phase_aimv2(fa, tq, tlm, tln, tsw) -> dict:
    """AIMv2-L/14's kernels and path (see the module's phase 43)."""
    from ttl_tpu_torch.models.aimv2 import rms_norm
    from ttl_tpu_torch.models.clip import linear
    from ttl_tpu_torch.ops import _build
    log("ptxas at AIMv2's head dim 128 and RMS statistics:")
    for key, used in sorted(_build.kernel_resources().items()):
        if ("attention_bshd.cu" in key and "mma_" in key and "ILi128E" in key
                or "rms_norm" in key or "ln_matmul_wgmma" in key
                and "Lb1E" in key):
            log(f"  {key}: {used}")
            if "mma_" not in key and not re.search(
                    r"\b0 bytes spill stores, 0 bytes spill loads", used):
                raise AssertionError(f"{key} spills: {used}")
    g = torch.Generator("cuda").manual_seed(SEED + 43)
    bf16 = torch.bfloat16
    results = {}
    # K1/K2 at 8 heads of 128, and 16 heads of 64 on the same bytes
    b, s, h, d = AIM_ROWS // 256, 256, AIM_HEADS, AIM_HD
    q, k, v, do = (torch.randn(b, s, h * d, device="cuda",
                               generator=g).to(bf16) for _ in range(4))
    for backward in (False, True):
        if fa.kernel_route(backward, bf16, s, d) != "tensor cores":
            raise AssertionError("K1/K2 at head dim 128 left the tensor "
                                 "cores")
    before = (fa.attention_bshd.fwd_launches, fa.attention_bshd.bwd_launches)
    out = fa.bshd_forward_cuda(q, k, v, h, s)
    grads = fa.bshd_backward_cuda(q, k, v, do, h, s)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.attention_bshd_plain(*leaves, h, s)
    ref.backward(do)
    torch.cuda.synchronize()
    if (fa.attention_bshd.fwd_launches, fa.attention_bshd.bwd_launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError("K1/K2 at head dim 128: no launch was counted")
    ref = ref.detach().float()
    fwd_err = (out.float() - ref).abs().max().item()
    if not fwd_err <= FWD_BOUND[bf16] * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"K1 at head dim 128: {fwd_err}")
    bwd_err = 0.0
    for got, leaf, name in zip(grads, leaves, "qkv"):
        want = leaf.grad.float()
        err = (got.float() - want).abs().max().item()
        if not torch.isfinite(got).all() or \
                not err <= BWD_BOUND_REL[bf16] * want.abs().max().item():
            raise AssertionError(f"K2's d{name} at head dim 128: {err}")
        bwd_err = max(bwd_err, err)
    del ref, leaves, grads, out
    if not torch.equal(fa.bshd_backward_cuda(q, k, v, do, h, s)[0],
                       fa.bshd_backward_cuda(q, k, v, do, h, s)[0]):
        raise AssertionError("K2 at head dim 128: two calls gave different "
                             "bits")
    shape = f"[{b}, {s}, {h * d}] bf16, {h} heads of {d}"
    for which, fn, fn64, n, flops in (
            ("fwd", lambda: fa.bshd_forward_cuda(q, k, v, h, s),
             lambda: fa.bshd_forward_cuda(q, k, v, 2 * h, s), 4, 4),
            ("bwd", lambda: fa.bshd_backward_cuda(q, k, v, do, h, s),
             lambda: fa.bshd_backward_cuda(q, k, v, do, 2 * h, s), 7, 10)):
        r = {"max_abs_err": fwd_err if which == "fwd" else bwd_err,
             "ms": median_ms(fn), "d64_ms": median_ms(fn64),
             **attention_bound(n, flops, b, h, s, d, bf16)}
        results[f"K{1 if which == 'fwd' else 2} {shape}"] = r
        log(f"K{1 if which == 'fwd' else 2} {shape}: " + ", ".join(
            f"{k_} {v_:.4g}" if isinstance(v_, float) else f"{k_} {v_}"
            for k_, v_ in r.items()))
    del q, k, v, do
    torch.cuda.empty_cache()
    # the RMS layernorm kernels, beside the centered ones
    x, scale, bias, dy = ln_inputs(g, AIM_ROWS, AIM_D, bf16)
    before = tln.layer_norm.rms_launches
    errs, out, grad, plain, leaf = ln_against_plain(tln, x, scale, bias, dy,
                                                    1e-5, "rms")
    if tln.layer_norm.rms_launches != before + 2:
        raise AssertionError("the RMS layernorm: its launches were not "
                             "counted as RMS")
    del out, grad, plain, leaf
    _, mu, rstd = tln.layer_norm_cuda(x, scale, None, 1e-5, True, "rms")
    _, cmu, crstd = tln.layer_norm_cuda(x, scale, bias, 1e-5, True)
    rows, width = x.shape
    r = {"fwd_max_abs_err": errs["fwd"][0], "bwd_max_abs_err": errs["bwd"][0],
         "fwd_differing": errs["fwd"][1], "bwd_differing": errs["bwd"][1],
         **in_turns({
             "ms": lambda: tln.layer_norm_cuda(x, scale, None, 1e-5,
                                               stats="rms"),
             "centered_ms": lambda: tln.layer_norm_cuda(x, scale, bias,
                                                        1e-5),
             "bwd_ms": lambda: tln.layer_norm_grad_cuda(
                 x, dy, scale, mu, rstd, stats="rms"),
             "centered_bwd_ms": lambda: tln.layer_norm_grad_cuda(
                 x, dy, scale, cmu, crstd)}),
         "bound_ms": rows * 2 * width * 2 / 3.35e9,
         "bwd_bound_ms": rows * 3 * width * 2 / 3.35e9, "bound_by": "bytes"}
    results[f"RMS layernorm [{rows}, {width}] bf16"] = r
    log(f"RMS layernorm [{rows}, {width}] bf16: " + ", ".join(
        f"{k_} {v_:.4g}" if isinstance(v_, float) else f"{k_} {v_}"
        for k_, v_ in r.items()))
    del dy, mu, rstd, cmu, crstd
    # the text tower's RMS width, its own instance of the kernels
    tx, tscale, tbias, tdy = ln_inputs(g, AIM_TEXT_ROWS, AIM_TEXT_D, bf16)
    errs = ln_against_plain(tln, tx, tscale, tbias, tdy, 1e-5, "rms")[0]
    r = {"fwd_max_abs_err": errs["fwd"][0], "bwd_max_abs_err": errs["bwd"][0],
         "fwd_differing": errs["fwd"][1], "bwd_differing": errs["bwd"][1]}
    results[f"RMS layernorm [{AIM_TEXT_ROWS}, {AIM_TEXT_D}] bf16"] = r
    log(f"RMS layernorm [{AIM_TEXT_ROWS}, {AIM_TEXT_D}] bf16: " + ", ".join(
        f"{k_} {v_:.4g}" for k_, v_ in r.items()))
    del tx, tscale, tbias, tdy
    # K6 with the RMS statistics, beside the unfolded pair and centered K6
    norm = {"scale": scale}
    matmul = torch.backends.cuda.matmul
    for n in AIM_K6_N:
        w = (torch.randn(width, n, device="cuda", generator=g)
             / width ** 0.5).to(bf16)
        zero = torch.zeros(n, device="cuda", dtype=bf16)
        before = (tlm.ln_matmul.launches, tlm.ln_matmul.rms_launches)
        got = tlm.ln_matmul(x, scale, None, w, None, 1e-5, "linear",
                            stats="rms")
        reduced = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            want = tlm.ln_matmul_plain(x, scale, None, w, None, 1e-5,
                                       "linear", stats="rms")
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        torch.cuda.synchronize()
        if (tlm.ln_matmul.launches, tlm.ln_matmul.rms_launches) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError("K6 RMS: no RMS launch was counted")
        diff = (got.float() - want.float()).abs()
        err, share = diff.max().item(), (diff > 0).float().mean().item()
        limit = K6_BOUND[bf16] * max(1.0, want.float().abs().max().item())
        shape = f"[{rows}, {width}] x [{width}, {n}] bf16"
        if not torch.isfinite(got).all() or not err <= limit \
                or not share < K6_LINEAR_SHARE:
            raise AssertionError(f"K6 RMS at {shape}: {err} > {limit} or "
                                 f"{share} of the outputs differ")
        del got, want, diff
        r = {"max_abs_err": err, "share_differ": share, **in_turns({
            "ms": lambda: tlm.ln_matmul(x, scale, None, w, None, 1e-5,
                                        "linear", stats="rms"),
            "chain_ms": lambda: linear(rms_norm(x, norm, 1e-5), {"w": w}),
            "centered_ms": lambda: tlm.ln_matmul(x, scale, bias, w, zero,
                                                 1e-5, "linear")}),
             **bound((rows * width + width * n + rows * n) * 2 + 4 * width,
                     2 * rows * width * n, bf16)}
        r["tflops"] = 2e-9 * rows * width * n / r["ms"]
        results[f"K6 RMS {shape}"] = r
        log(f"K6 RMS {shape}: " + ", ".join(
            f"{k_} {v_:.4g}" if isinstance(v_, float) else f"{k_} {v_}"
            for k_, v_ in r.items()))
        del w, zero
    del x, scale, bias
    torch.cuda.empty_cache()
    # the bias-free SwiGLU at AIMv2's width, timed at the prefix's rows
    for rows, f, dtype in AIM_SWIGLU_SHAPES:
        gu = torch.randn(rows, 2 * f, device="cuda", generator=g) * 3
        dy = torch.randn(rows, f, device="cuda", generator=g)
        results[f"SwiGLU [{rows}, 2 x {f}] bf16"] = swiglu_against_plain(
            tsw, gu.to(dtype), dy.to(dtype), timed=rows == AIM_ROWS)
        del gu, dy
        torch.cuda.empty_cache()
    results["path"] = phase_path(
        fa, tq, "AIMv2-L/14", config("--arch", "AIMv2-L-14-224-LiT"),
        AIM_PATH, (LN_TEXT, LN_MAIN), rms=True)
    return results


def phase_k6(tlm) -> dict:
    """K6 against ln_matmul_plain on the card at K6_SHAPES, with the pair of
    library calls that computes the same function (F.layer_norm, F.linear;
    w transposed to F.linear's layout outside the timing) and the package's
    own layer_norm + linear, the pair K6 stands in for, timed beside it;
    then K6 with `linear`'s epilogue (QuickGELU too where N = 4K) against
    ln_matmul_plain's, which sums the product in f32 (no reduced-precision
    reduction), within K6_BOUND and with under K6_LINEAR_SHARE of the
    outputs differing, and the chain it stands for on the frozen prefix
    (layer_norm -> linear -> quick_gelu) timed beside it; ptxas's
    registers, shared memory and spills of its kernels first (the wgmma
    kernels may spill nothing), the achieved rate at every shape, and at
    fc1 a second call on the same inputs, which must give the same bits."""
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
        del got, want
        r.update(k6_linear(tlm, x, scale, bias, w, b.to(dtype), shape))
        del x, w, wt
    return results


def k6_linear(tlm, x, scale, bias, w, b, shape: str) -> dict:
    """phase_k6's `linear`-epilogue check and times at one shape; b in x's
    dtype."""
    from ttl_tpu_torch.models.clip import layer_norm, linear, quick_gelu
    k, n = w.shape
    epi = {"epilogue": "linear", "quick_gelu": n == 4 * k}
    before = (tlm.ln_matmul.launches, tlm.ln_matmul.linear_launches)
    got = tlm.ln_matmul(x, scale, bias, w, b, 1e-5, **epi)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = tlm.ln_matmul_plain(x, scale, bias, w, b, 1e-5, **epi)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    torch.cuda.synchronize()
    if (tlm.ln_matmul.launches, tlm.ln_matmul.linear_launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError(f"K6 linear at {shape}: no launch was counted")
    diff = (got.float() - want.float()).abs()
    err, share = diff.max().item(), (diff > 0).float().mean().item()
    limit = K6_BOUND[x.dtype] * max(1.0, want.float().abs().max().item())
    if not torch.isfinite(got).all() or not err <= limit or (
            x.dtype == torch.bfloat16 and not share < K6_LINEAR_SHARE):
        raise AssertionError(f"K6 linear at {shape} disagrees with its plain "
                             f"version: {err} > {limit} or {share} of the "
                             f"outputs differ")
    del got, want, diff
    ms = median_ms(lambda: tlm.ln_matmul(x, scale, bias, w, b, 1e-5, **epi))
    ln_p, lin_p = {"scale": scale, "bias": bias}, {"w": w, "b": b}
    act = quick_gelu if epi["quick_gelu"] else (lambda y: y)
    chain_ms = median_ms(lambda: act(linear(layer_norm(x, ln_p, 1e-5),
                                            lin_p)))
    m = x.shape[0]
    log(f"K6 {shape}, `linear`'s epilogue"
        f"{' + QuickGELU' if epi['quick_gelu'] else ''}: max_abs_err "
        f"{err:.3e} (bound {limit:.3e}), {100 * share:.4f} % of the outputs "
        f"differ, kernel {ms:.4f} ms ({2e-9 * m * k * n / ms:.1f} TFLOP/s), "
        f"the chain layer_norm -> linear"
        f"{' -> quick_gelu' if epi['quick_gelu'] else ''} {chain_ms:.4f} ms")
    return {"linear_max_abs_err": err, "linear_share_differ": share,
            "linear_ms": ms, "linear_chain_ms": chain_ms,
            "linear_gelu": epi["quick_gelu"]}


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


def op_table(rows: list) -> str:
    """`utils.profiling.op_stats` rows as lines: device ms, launches, share
    of the device time, the operation's name."""
    return "\n".join(f"  {r['self_time_us'] / 1e3:9.3f} ms "
                     f"{r['occurrences']:6d}x {100 * r['fraction']:5.1f}%  "
                     f"{r['operation'][:120]}" for r in rows)


def profiled(fn, *args):
    """fn(*args) under `utils.profiling.trace`, waited for: (its result, the
    device busy ms, the table of the top device operations), read from the
    trace by the module that `--profile` reads it with."""
    import tempfile
    from ttl_tpu_torch.utils.profiling import device_busy_us, op_stats, trace
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, "cuda"):
            res = fn(*args)
        return res, device_busy_us(tmp) / 1e3, op_table(op_stats(tmp))


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


# K6's launches a batch with `linear`'s epilogue (and in "K6" too): the
# 9-layer frozen prefix at ViT-B/16, and the whole 12-layer tower
K6_PREFIX = {"K6": 36, "K6 linear": 36}
K6_TOWER = {"K6": 48, "K6 linear": 48}


def launch_counts(fa, tq) -> dict:
    from ttl_tpu_torch.ops.ln_matmul import ln_matmul
    return {"K1": fa.attention_bshd.fwd_launches,
            "K2": fa.attention_bshd.bwd_launches,
            "K3 fwd": fa.attention_per_head.fwd_launches,
            "K3 bwd": fa.attention_per_head.bwd_launches,
            "K4 fwd": fa.attention_heads.fwd_launches,
            "K4 bwd": fa.attention_heads.bwd_launches,
            "K5": tq.linear_q.launches, "K6": ln_matmul.launches,
            "K6 linear": ln_matmul.linear_launches,
            "K6 RMS": ln_matmul.rms_launches}


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
    from ttl_tpu_torch.ops.layer_norm import layer_norm
    from ttl_tpu_torch.ops.ln_matmul import ln_matmul
    fa.reset_launch_counts()
    tq.linear_q.launches = 0
    ln_matmul.launches = ln_matmul.linear_launches = 0
    ln_matmul.rms_launches = 0
    layer_norm.launches = layer_norm.rms_launches = 0


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


def phase_path(fa, tq, name: str, cfg, per_batch: dict, ln: tuple,
               timed: bool = True, rms: bool = False) -> dict:
    """Drive runner.run over 16 images and check the launches per batch
    (kernels `per_batch` does not name must not launch) and the layernorm
    launches of the run, `ln` = (once, a batch), every one of them with the
    RMS statistics where `rms` and none otherwise; then, if `timed`,
    time 80 images in steady state, with the run's peak device memory, and
    profile one batch."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.ops.layer_norm import layer_norm

    original = getattr(runner, step_factory(cfg))
    per_batch = {**dict.fromkeys(launch_counts(fa, tq), 0), **per_batch}

    probe = StepProbe(original)
    start = time.perf_counter()
    reset_counts(fa, tq)
    res = drive(cfg, probe, 16)
    counts = launch_counts(fa, tq)
    n_batches = len(probe.starts)
    ln_run = layer_norm.launches
    log(f"{name}: {n_batches} batches, launches {counts}, layer_norm "
        f"{ln_run} over the run, top1/top5 {res['A']}, whole run "
        f"{time.perf_counter() - start:.1f} s")
    expect = {k: v * n_batches for k, v in per_batch.items()}
    if n_batches != 2 or counts != expect:
        raise AssertionError(f"{name}: expected {per_batch} launches per "
                             f"batch, got {counts} over {n_batches} batches")
    if ln_run != ln[0] + ln[1] * n_batches:
        raise AssertionError(f"{name}: expected {ln[0]} layernorm launches "
                             f"once and {ln[1]} a batch, got {ln_run} over "
                             f"{n_batches} batches")
    if layer_norm.rms_launches != (ln_run if rms else 0):
        raise AssertionError(f"{name}: {layer_norm.rms_launches} of the "
                             f"{ln_run} layernorm launches took the RMS "
                             f"statistics, expected {'all' if rms else 0}")
    top1, top5 = res["A"]
    if not (0.0 <= top1 <= 100.0 and 0.0 <= top5 <= 100.0):
        raise AssertionError(f"top-1/top-5 out of range: {res['A']}")
    if not timed:
        return {"launches": counts, "layer_norm": ln_run}

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
            "busy_ms": profiled.busy_ms, "layer_norm": ln_run}


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
    # the counterfactual pass adds ln_pre, the window's 6 and ln_post; the
    # int8 prefix 18 a pass
    path = phase_path(fa, tq, "PLPD", cfg,
                      {"K1": 27, "K2": 3, "K6": 72, "K6 linear": 72},
                      (LN_TEXT, LN_MAIN + 8))
    phase_card_vs_cpu(cfg, "PLPD", "PLPD")
    int8 = phase_path(fa, tq, "PLPD, int8 prefix",
                      config("--prefix_quant", "int8", *PLPD_FLAGS),
                      {"K1": 27, "K2": 3, "K5": 108},
                      (LN_TEXT, LN_MAIN + 8 + 2 * 18), timed=False)
    return path, int8


def phase_augmix(fa, tq) -> dict:
    """`--aug_list` over DEFAULT_AUG_LIST: the path timed (phase_path), the
    view maker's time with and without AugMix, one sample's views card
    against CPU."""
    from ttl_tpu_torch.ops.augmix import DEFAULT_AUG_LIST
    cfg = config("--aug_list", ",".join(DEFAULT_AUG_LIST))
    path = phase_path(fa, tq, "AugMix", cfg, {"K1": 15, "K2": 3,
                                              **K6_PREFIX},
                      (LN_TEXT, LN_MAIN))
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
                         {"K4 fwd": 48, "K4 bwd": 12}, (0, 124))
        phase_card_vs_cpu(tpt_cfg, "RN50 prompt tuning, heads route",
                          "RN50 prompt tuning")
    zs_cfg = config("-a", "RN50", "--tta_steps", "0")
    zero_shot = phase_path(fa, tq, "RN50 zero-shot", zs_cfg, {},
                           (LN_TEXT, 0))
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
            ((), None, {"K1": 15, "K2": 3, **K6_PREFIX})}
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
    adapted = {"K1": 18, "K2": 3, **K6_PREFIX}
    runs = {"predict": ((), adapted),
            "predict, --tta_steps 0": (("--tta_steps", "0"),
                                       {"K1": 12, **K6_TOWER}),
            "predict, int8 prefix": (("--prefix_quant", "int8"),
                                     {"K1": 18, "K2": 3, "K5": 54})}
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
    # K6: the support encoder's whole tower (48) and the queries' prefix
    # (36), or at --tta_steps 0 the queries' whole tower too
    adapted = {"K1": 27, "K2": 3, "K6": 84, "K6 linear": 84}
    runs = {"Bongard": ((), adapted),
            "Bongard, again": ((), adapted),
            "Bongard zero-shot": (("--tta_steps", "0"),
                                  {"K1": 24, "K6": 96, "K6 linear": 96}),
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


def write_image_folder(root: str, n: int, seed: int) -> str:
    """`n` images (`write_images`) over 8 class folders of set A's layout
    under `root` (`imagenet-adversarial/imagenet-a/<class>/`), as a user's
    `DATA` holds them; returns `root`."""
    from ttl_tpu_torch.data.registry import ID_TO_DIRNAME
    for c in range(8):
        write_images(os.path.join(root, ID_TO_DIRNAME["A"], f"class{c:02d}"),
                     n // 8 + (c < n % 8), seed + c)
    return root


def phase_profile(fa, tq, build_dir, main_rate: float) -> dict:
    """`python -m ttl_tpu_torch DATA --test_sets A --profile DIR` through
    `cli.main` at ViT-B/16 over 80 images on disk (set A's layout, JPEG and
    PNG): 15 K1 and 3 K2 launches a batch; DIR holds one trace, whose
    `op_stats` rows name K1's kernel and K2's two kernels at those launches,
    and whose untruncated busy time is at least the top 15 rows' sum. The
    steady s/batch under the profiler beside phase 4's, and the device
    time's sum beside its union (copies on the upload stream overlap
    compute)."""
    import tempfile
    from ttl_tpu_torch import cli, runner
    from ttl_tpu_torch.utils.profiling import (device_busy_us,
                                               device_union_us, op_stats)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        data = write_image_folder(os.path.join(tmp, "data"), 80, SEED + 71)
        log_dir = os.path.join(tmp, "profile")
        probe = StepProbe(runner.make_fused_ttl_fn)
        runner.make_fused_ttl_fn = probe
        reset_counts(fa, tq)
        start = time.perf_counter()
        try:
            res = cli.main([data, "--test_sets", "A", "--seed", str(SEED),
                            "--profile", log_dir])
        finally:
            runner.make_fused_ttl_fn = probe.make_step
        seconds = time.perf_counter() - start
        counts = launch_counts(fa, tq)
        probe.check(8, 200)
        traces = os.listdir(log_dir)
        rows = op_stats(log_dir, top=10 ** 6)
        busy_us, union_us = device_busy_us(log_dir), device_union_us(log_dir)
    n = len(probe.starts)
    expect = {**dict.fromkeys(counts, 0), "K1": 15 * n, "K2": 3 * n,
              **{k: v * n for k, v in K6_PREFIX.items()}}
    log(f"--profile: {n} batches, launches {counts}, top1/top5 {res['A']}, "
        f"whole call {seconds:.1f} s; {traces}")
    if n != 10 or counts != expect or len(traces) != 1:
        raise AssertionError(f"--profile: expected 10 batches of 15 K1 and 3 "
                             f"K2 launches and one trace, got {n}, {counts}, "
                             f"{traces}")

    def launches_of(kernel):
        return sum(r["occurrences"] for r in rows if kernel in r["operation"])

    named = {k: launches_of(k) for k in ("mma_fwd_kernel",
                                          "mma_bwd_rows_kernel",
                                          "mma_bwd_keys_kernel")}
    top15 = sum(r["self_time_us"] for r in rows[:15])
    log(f"--profile: op_stats names K1 and K2 at {named} launches; device "
        f"busy {busy_us / 1e3:.3f} ms (top 15 rows {top15 / 1e3:.3f} ms) over "
        f"{len(rows)} operations")
    if named != {"mma_fwd_kernel": 15 * n, "mma_bwd_rows_kernel": 3 * n,
                 "mma_bwd_keys_kernel": 3 * n} or busy_us < top15:
        raise AssertionError(f"--profile: op_stats rows {named}, busy "
                             f"{busy_us} < top 15 {top15}")
    pace = np.diff(probe.starts[config().pipeline_depth + 1:])
    rate = 8 / np.median(pace)
    log(f"--profile steady state: s/batch {pace.tolist()}, median "
        f"{np.median(pace):.4f} s, samples/s {rate:.3f} against phase 4's "
        f"{main_rate:.3f} ({100 * (main_rate / rate - 1):.1f}% longer a "
        f"batch under the profiler)")
    log(f"--profile: device time of the run, sum of the operations "
        f"{busy_us / 1e3:.3f} ms, union of their intervals "
        f"{union_us / 1e3:.3f} ms ({busy_us / union_us:.4f}x; per batch "
        f"{busy_us / 1e3 / n:.3f} and {union_us / 1e3 / n:.3f} ms)")
    return {"launches": counts, "samples_per_s": rate, "busy_ms": busy_us
            / 1e3 / n, "union_ms": union_us / 1e3 / n}


ANALYSIS_BOUND = 1e-4     # card against CPU, f32 attention probabilities


def phase_analysis() -> dict:
    """`utils.analysis` at ViT-B/16 (f32 weights from the seed) over 2
    images at 224 px on the card: every attention row sums to 1 within 1e-3,
    the maps agree with a CPU run within ANALYSIS_BOUND, and the rollout
    (discard_ratio 0 and 0.1) and the overlay are finite in [0, 1]."""
    from ttl_tpu_torch.models.clip import init_clip_params
    from ttl_tpu_torch.models.zoo import get_arch
    from ttl_tpu_torch.utils.analysis import (attention_rollout,
                                              heatmap_overlay,
                                              vision_attention_maps)
    vcfg = get_arch("ViT-B/16").vision
    params = init_clip_params(get_arch("ViT-B/16"),
                              torch.Generator().manual_seed(SEED),
                              device=torch.device("cpu"),
                              param_dtype=torch.float32)["vision"]
    images = torch.from_numpy(np.random.default_rng(SEED + 81)
                              .standard_normal((2, 3, 224, 224))
                              .astype(np.float32))
    from ttl_tpu_torch.models.clip import tree_map
    start = time.perf_counter()
    card = vision_attention_maps(tree_map(lambda t: t.cuda(), params),
                                 images.cuda(), vcfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - start
    cpu = vision_attention_maps(params, images, vcfg)
    err = (card.cpu() - cpu).abs().max().item()
    row_err = (card.sum(-1) - 1).abs().max().item()
    rel = {r: attention_rollout(card, r) for r in (0.0, 0.1)}
    overlay = heatmap_overlay(np.random.default_rng(SEED + 82).random(
        (224, 224, 3)).astype(np.float32), rel[0.0][0].cpu().numpy())
    log(f"analysis: maps {tuple(card.shape)} in {card_s:.3f} s on the card; "
        f"rows sum to 1 within {row_err:.2e}; card against CPU {err:.3e} "
        f"(bound {ANALYSIS_BOUND:.0e}); rollout ranges "
        + ", ".join(f"{r}: [{v.min().item():.4f}, {v.max().item():.4f}]"
                    for r, v in rel.items())
        + f"; overlay [{overlay.min():.4f}, {overlay.max():.4f}]")
    in_unit = [np.isfinite(x).all() and x.min() >= 0 and x.max() <= 1 + 1e-6
               for x in [v.cpu().numpy() for v in rel.values()] + [overlay]]
    if card.shape != (12, 2, 12, 197, 197) or row_err > 1e-3 \
            or err > ANALYSIS_BOUND or not all(in_unit):
        raise AssertionError(f"analysis: rows {row_err}, card against CPU "
                             f"{err}, in [0, 1]: {in_unit}")
    return {"max_abs_err": err}


def rank_worker(argv: list) -> int:
    """One process of phases 33 and 34: `cli.main(argv[3:])` with a
    StepProbe in the runner's place of make_fused_ttl_fn; then, where
    argv[1] names a second port, the first local batch once more through
    `parallel.eval.make_sharded_ttl_fn` in a group joined on that port. The
    launches, the head count of each K1 launch, results, each batch's
    logits with the rows' dataset indices, the dispatch clock, the host ms
    of each all-reduce of the counts, the host ms and number of the model
    group's collectives, and the gathered logits go to the JSON file
    argv[0]; where argv[2] is "grads", the gradient of every AdamW update
    (which waits for the device at each step) goes to argv[0] + ".pt"."""
    import torch.distributed as dist
    from ttl_tpu_torch import cli, runner
    from ttl_tpu_torch.adapt.ttl import compute_dtype
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.data.registry import build_dataset
    from ttl_tpu_torch.data.views import SampleLoader
    from ttl_tpu_torch.ops import attention as fa
    from ttl_tpu_torch.ops import quant as tq
    from ttl_tpu_torch.ops.image import render_views
    from ttl_tpu_torch.parallel.eval import (all_gather_rows,
                                             make_sharded_ttl_fn)
    from ttl_tpu_torch.adapt import ttl
    from ttl_tpu_torch.parallel.mesh import make_mesh
    out_path, second_port, cli_argv = argv[0], argv[1], argv[3:]
    probe = StepProbe(runner.make_fused_ttl_fn)
    runner.make_fused_ttl_fn = probe
    meshes, heads, grads = [], [], []
    runner.make_mesh = lambda *a, **k: meshes.append(make_mesh(*a, **k)) \
        or meshes[-1]
    forward, adamw = fa.bshd_forward_cuda, ttl._adamw

    def counted_forward(q, k, v, h, seq_len):
        heads.append(h)
        return forward(q, k, v, h, seq_len)

    def recording(params, g, *rest):
        grads.append(torch.cat([t.detach().float().flatten().cpu()
                                for t in g]))
        return adamw(params, g, *rest)

    fa.bshd_forward_cuda = counted_forward
    if argv[2] == "grads":
        ttl._adamw = recording
    all_reduce, reduce_ms = dist.all_reduce, []

    def timed_all_reduce(t, *args, **kw):
        start = time.perf_counter()
        all_reduce(t, *args, **kw)
        # the counts (int64); the model group's f32 sums are timed by its
        # own clock (parallel.tensor.ModelGroup)
        if t.dtype == torch.int64:
            reduce_ms.append(1e3 * (time.perf_counter() - start))

    dist.all_reduce = timed_all_reduce
    reset_counts(fa, tq)
    try:
        results = cli.main(cli_argv)
    finally:
        dist.all_reduce = all_reduce
    counts = launch_counts(fa, tq)
    cfg = cli.config_from_args(cli.build_parser().parse_args(cli_argv))
    mesh = meshes[0]
    n_data = mesh.shape["data"]
    local_bs = cfg.sample_batch // n_data
    probe.check(local_bs, len(resolve_classnames(cfg.test_sets)))

    def loader():
        return SampleLoader(build_dataset(cfg.test_sets, cfg),
                            batch_size=local_bs,
                            seed=cfg.seed, canvas=cfg.canvas,
                            shard=(mesh.data_index, n_data) if n_data > 1
                            else None)

    model = mesh.model
    out = {"launches": counts, "results": results, "starts": probe.starts,
           "reduce_ms": reduce_ms, "heads": sorted(set(heads)),
           "model_ms": None if model is None else 1e3 * model.seconds,
           "model_calls": None if model is None else model.calls,
           "model_backend": None if model is None else model.backend,
           "indices": loader().order.tolist(),
           "logits": torch.cat(probe.logits).float().cpu().tolist()}
    if second_port != "-":
        os.environ["MASTER_PORT"] = second_port
        dist.init_process_group("gloo", init_method="env://")
        try:
            device = torch.device(
                f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
            mesh = make_mesh(cfg.mesh_shape, device)
            clip_cfg, params = runner.load_model(cfg, device)
            adapters0 = runner.make_adapters0(cfg, clip_cfg, device)
            text_cls = runner.text_classifier(cfg.test_sets, cfg, clip_cfg,
                                              params, device=device)
            b = next(iter(loader()))
            draws = {k: t.to(device) for k, t in
                     runner.sample_draws(cfg, b.indices).items()}
            with torch.no_grad():
                views = render_views(
                    *(torch.from_numpy(x).to(device)
                      for x in (b.canvases, b.heights, b.widths)),
                    draws, out_size=cfg.resolution,
                    out_dtype=compute_dtype(cfg))
            res = make_sharded_ttl_fn(clip_cfg, cfg, mesh)(
                params, text_cls, adapters0, views, draws.get("plpd_perm"))
            out["sharded_indices"] = all_gather_rows(
                torch.from_numpy(b.indices)).tolist()
            out["sharded_logits"] = res.logits.float().cpu().tolist()
        finally:
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    if grads:
        torch.save(grads, out_path + ".pt")
    return 0


DP_IMAGES = 128


def write_cifar10(root: str, n: int, seed: int) -> str:
    """`n` 32 x 32 noise images with labels 0-9 as a CIFAR-10 test batch
    (`root/cifar-10-batches-py/test_batch`, the python pickle layout); returns
    `root`."""
    import pickle
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "cifar-10-batches-py"))
    with open(os.path.join(root, "cifar-10-batches-py", "test_batch"),
              "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                     b"labels": rng.integers(0, 10, n).tolist()}, f)
    return root


def phase_data_parallel(build_dir, cards: int = 1) -> dict:
    """Data-parallel evaluation as two one-card hosts would run it, both
    ranks on cuda:0: two processes of `cli.main([DATA, --test_sets cifar10,
    --init_distributed, --sample_batch 16, --canvas 32])` (RANK 0 and 1,
    WORLD_SIZE 2, LOCAL_RANK 0, a free MASTER_PORT; LOCAL_RANK r % `cards`
    as torch.distributed.run gives it where `cards` > 1), each a local
    batch of 8 over its shard of 128 images (10 classes, so that the counts
    are not all zero at random weights); then one process with `--sample_batch 8`.
    Both ranks exit 0 with the single process's top-1 and top-5, 15 K1 and
    3 K2 launches a local batch, rank 0 alone prints the summary. Each
    sample's logits are compared, by dataset index, with the single
    process's: the runner's, and the first local batches'
    gathered through `make_sharded_ttl_fn`; a difference is printed, and
    must stay within GRAD_BOUND_REL["main path"] of the largest logit at
    the same top-1. The steady s/batch of each process is printed (two
    ranks share one card, so it is no scaling figure), and the host ms of
    each rank's all-reduce of the counts, a batch."""
    import tempfile
    ports = [free_port(), free_port()]
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        data = write_cifar10(os.path.join(tmp, "data"), DP_IMAGES, SEED + 91)
        flags = [data, "--test_sets", "cifar10", "--seed", str(SEED),
                 "--canvas", "32"]
        t0 = time.perf_counter()
        env = {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": ports[0]}
        ranks = finish_ranks(tmp, start_ranks(
            tmp, {f"rank {r}": flags + ["--init_distributed", "--sample_batch",
                                        "16"] for r in range(2)},
            {f"rank {r}": {**env, "RANK": str(r), "LOCAL_RANK": str(r % cards)}
             for r in range(2)}, second_port=ports[1]))
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = finish_ranks(tmp, start_ranks(
            tmp, {"one process": flags + ["--sample_batch", "8"]},
            {"one process": {}}))["one process"]
        single_s = time.perf_counter() - t0

    def by_index(run, key="logits", index_key="indices"):
        return dict(zip(run[index_key], np.asarray(run[key], np.float32)))

    want = by_index(single)
    n_local = DP_IMAGES // 16
    lines = []
    for name, run in ranks.items():
        expect = {**dict.fromkeys(run["launches"], 0), "K1": 15 * n_local,
                  "K2": 3 * n_local,
                  **{k: v * n_local for k, v in K6_PREFIX.items()}}
        summary = "Result Summary" in run["stdout"]
        if run["results"] != single["results"] or run["launches"] != expect \
                or summary != (name == "rank 0") \
                or single["results"]["cifar10"][1] == 0.0:
            raise AssertionError(f"{name}: results {run['results']} against "
                                 f"{single['results']}, launches "
                                 f"{run['launches']}, summary printed: "
                                 f"{summary}")
        for key, index_key in (("logits", "indices"),
                               ("sharded_logits", "sharded_indices")):
            got = by_index(run, key, index_key)
            diff = max(np.abs(got[i] - want[i]).max() for i in got)
            same = sum(np.array_equal(got[i], want[i]) for i in got)
            top1 = all(got[i].argmax() == want[i].argmax() for i in got)
            scale = max(np.abs(want[i]).max() for i in got)
            lines.append(f"{name}, {key}: {same} of {len(got)} samples bit "
                         f"for bit the single process's, largest difference "
                         f"{diff:.3e} ({diff / scale:.3e} of the largest "
                         f"logit), top-1 {'agrees' if top1 else 'DIFFERS'}")
            if not top1 or diff > GRAD_BOUND_REL["main path"] * scale:
                raise AssertionError(lines[-1])
    depth = config().pipeline_depth
    pace = {name: np.median(np.diff(run["starts"][depth + 1:]))
            for name, run in {**ranks, "one process": single}.items()}
    log("data-parallel: " + "; ".join(lines))
    log("data-parallel: the all-reduce of a batch's counts, host ms "
        + "; ".join(f"{name} median {np.median(run['reduce_ms']):.3f} over "
                    f"{len(run['reduce_ms'])} calls, {run['reduce_ms']}"
                    for name, run in ranks.items()))
    log(f"data-parallel: results {single['results']} on both ranks and the "
        f"single process; launches a rank {ranks['rank 0']['launches']} over "
        f"{n_local} local batches; rank 0 alone printed the summary; "
        f"steady s/batch (median of the dispatch clock) "
        + ", ".join(f"{k} {v:.4f}" for k, v in pace.items())
        + (" (two ranks share one card: no scaling figure)" if cards == 1
           else f" (a rank a card, on {cards} cards)")
        + f"; the two ranks "
        f"took {ranks_s:.1f} s, the single process {single_s:.1f} s, start "
        f"and set-up included")
    return {**{name: {"launches": run["launches"]}
               for name, run in ranks.items()},
            "pace": pace}


MA_IMAGES = 12


def start_ranks(tmp: str, argvs: dict, envs: dict, second_port: str = "-",
                grads: bool = False) -> dict:
    """`rank_worker` processes by name (argv, extra environment; the
    worker's argv[1] is `second_port`, and with `grads` it records every
    AdamW update's gradient), their output in tmp/<name>.log and their
    results in tmp/<name>.json."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for name, argv in argvs.items():
        with open(os.path.join(tmp, name + ".log"), "w") as log_file:
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                 "chip_smoke.rank_worker(sys.argv[1:]))",
                 os.path.join(tmp, name + ".json"), second_port,
                 "grads" if grads else "-", *argv],
                cwd=root, env={**os.environ, **envs[name]},
                stdout=log_file, stderr=subprocess.STDOUT)
    return procs


def finish_ranks(tmp: str, procs: dict, timeout: float = 900) -> dict:
    """Wait for `start_ranks`' processes (killing any left); each must exit
    0; their JSON results with their output under "stdout"."""
    try:
        for p in procs.values():
            p.wait(timeout=timeout)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name, p in procs.items():
        with open(os.path.join(tmp, name + ".log")) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"{name} exited {p.returncode}:\n"
                                 + text[-4000:])
        with open(os.path.join(tmp, name + ".json")) as f:
            out[name] = {**json.load(f), "stdout": text}
        grads = os.path.join(tmp, name + ".json.pt")
        if os.path.exists(grads):
            out[name]["grads"] = torch.load(grads)
    return out


def free_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def relative_error(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_model_axis(build_dir, cards: int = 1, seed: int = SEED + 92,
                     bound: Optional[dict] = None) -> dict:
    """The model axis as two one-card ranks of one model group run it:
    two `rank_worker` processes of `cli.main([DATA, --test_sets A,
    --init_distributed, --mesh_shape 1,2, --sample_batch 2])` (RANK 0 and
    1, WORLD_SIZE 2, LOCAL_RANK r % `cards`: both on cuda:0, gloo, by
    default; two cards over NCCL with `cards` 2) over MA_IMAGES images on
    disk in set A's layout (200 classes: the classifier is split by
    classes), then one process at `--sample_batch 2`. Both ranks exit 0
    with the one process's top-1 and top-5; each runs 15 K1 and 3 K2 a
    batch, every K1 at 6 heads (the one process at 12); rank 0 alone
    prints the summary; every sample's top-1 is the one process's, and on
    rank 0 every sample's logits and every batch's first-update gradient lie
    within `bound` (MODEL_AXIS_BOUND_REL; None: printed only) of their
    largest element. Prints each rank's steady s/batch and the host ms of
    the model group's collectives a batch. Returns the launches and the
    errors."""
    import tempfile
    bound = MODEL_AXIS_BOUND_REL if bound is None else bound
    env = {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": free_port()}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        data = write_image_folder(os.path.join(tmp, "data"), MA_IMAGES, seed)
        flags = [data, "--test_sets", "A", "--seed", str(SEED),
                 "--sample_batch", "2"]
        ranks = finish_ranks(tmp, start_ranks(
            tmp, {f"rank {r}": flags + ["--init_distributed", "--mesh_shape",
                                        "1,2"] for r in range(2)},
            {f"rank {r}": {**env, "RANK": str(r),
                           "LOCAL_RANK": str(r % cards)} for r in range(2)},
            grads=True))
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = finish_ranks(tmp, start_ranks(
            tmp, {"one process": flags}, {"one process": {}},
            grads=True))["one process"]
        single_s = time.perf_counter() - t0
    n_batches = MA_IMAGES // 2
    want = np.asarray(single["logits"])
    errors = {"logits": 0.0, "gradient": 0.0}
    for name, run in ranks.items():
        expect = {**dict.fromkeys(run["launches"], 0), "K1": 15 * n_batches,
                  "K2": 3 * n_batches,
                  **{k: v * n_batches for k, v in K6_PREFIX.items()}}
        summary = "Result Summary" in run["stdout"]
        got = np.asarray(run["logits"])
        if run["results"] != single["results"] or run["launches"] != expect \
                or run["heads"] != [6] or single["heads"] != [12] \
                or not len(run["grads"]) == len(single["grads"]) == n_batches \
                or summary != (name == "rank 0") \
                or run["indices"] != single["indices"] \
                or not np.array_equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(
                f"model axis, {name}: results {run['results']} against "
                f"{single['results']}, launches {run['launches']}, heads a "
                f"K1 launch {run['heads']} (one process {single['heads']}), "
                f"summary printed: {summary}, top-1 "
                f"{got.argmax(-1).tolist()} against "
                f"{want.argmax(-1).tolist()}")
        if name == "rank 0":
            errors["logits"] = max(relative_error(g, w)
                                   for g, w in zip(got, want))
            errors["gradient"] = max(
                relative_error(g, w)
                for g, w in zip(run["grads"], single["grads"]))
    first, second = ranks.values()
    same = first["logits"] == second["logits"] and all(
        torch.equal(a, b) for a, b in zip(first["grads"], second["grads"]))
    pace = {name: float(np.median(np.diff(run["starts"][1:])))
            for name, run in {**ranks, "one process": single}.items()}
    log(f"model axis ({first['model_backend']}, "
        f"{'both ranks on cuda:0' if cards == 1 else f'{cards} cards'}): "
        f"results {single['results']} on both ranks and the one process; "
        f"launches a rank {first['launches']} over {n_batches} batches, "
        f"every K1 at 6 heads (one process: 12); the two ranks' logits and "
        f"gradients {'bit for bit' if same else 'DIFFER'}; rank 0 against "
        f"the one process, largest over the samples and batches relative "
        f"to the largest element: logits {errors['logits']:.3e}, "
        f"first-update gradient {errors['gradient']:.3e} (bounds "
        + (f"{bound['logits']:.3e}, {bound['gradient']:.3e}"
           if bound else "none: a noise run") + ")")
    log("model axis: steady s/batch (median past the first batch) "
        + ", ".join(f"{k} {v:.4f}" for k, v in pace.items())
        + "; the model group's collectives a batch, host ms "
        + ", ".join(f"{name} {run['model_ms'] / n_batches:.1f} "
                    f"({run['model_calls'] / n_batches:.0f} calls)"
                    for name, run in ranks.items())
        + f"; the ranks took {ranks_s:.1f} s, the one process "
        f"{single_s:.1f} s, start and set-up included")
    if not same or (bound and (errors["logits"] > bound["logits"]
                               or errors["gradient"] > bound["gradient"])):
        raise AssertionError(f"model axis: the ranks disagree with each "
                             f"other or with the one process: {errors}")
    return {"launches": {name: run["launches"]
                         for name, run in ranks.items()},
            "errors": errors, "pace": pace,
            "model_ms": {name: run["model_ms"] / n_batches
                         for name, run in ranks.items()}}


def serve_ranks(mesh_shape: str, envs: list, port: int) -> list:
    """`python -m ttl_tpu_torch.serve --test_sets I --sample_batch 2
    --mesh_shape <mesh_shape> --port <port>` in one process a rank, as
    `torch.distributed.run` starts it (`envs`: each rank's RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns (process, lines, ready
    event) for each."""
    import threading
    cmd = [sys.executable, "-m", "ttl_tpu_torch.serve", "--test_sets", "I",
           "--sample_batch", "2", "--mesh_shape", mesh_shape, "--port",
           str(port)]
    out = []
    for env in envs:
        proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, **env}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines, ready = [], threading.Event()

        def read(proc=proc, lines=lines, ready=ready):
            for line in proc.stdout:
                lines.append(line.rstrip())
                if "serving on" in line:
                    ready.set()
            ready.set()

        threading.Thread(target=read, daemon=True).start()
        out.append((proc, lines, ready))
    return out


def phase_serve_ranks() -> dict:
    """Serving over two ranks on cuda:0: `python -m ttl_tpu_torch.serve
    --test_sets I --sample_batch 2 --mesh_shape 2`, then `--mesh_shape
    1,2`, two processes each (`serve_ranks`); rank 0 serves HTTP, rank 1
    follows. A burst of 8 PNG POSTs at once answers 8 x 200 with the top-1
    labels and zero-shot labels of the one-process predictor
    (`serve.TTLPredictor` in this process, as the one-process server builds
    it) on the same images, each answer's top-5 probabilities within
    MODEL_AXIS_BOUND_REL["logits"] of the largest; SIGTERM to rank 0
    drains, stops rank 1, and both exit 0."""
    import io
    import signal
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.data.classnames import resolve_classnames
    from ttl_tpu_torch.serve import TTLPredictor
    rng = np.random.default_rng(SEED + 53)
    images = [rng.integers(0, 256, SyntheticImages.SIZES[i % 4] + (3,),
                           dtype=np.uint8) for i in range(8)]
    bodies = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        bodies.append(buf.getvalue())
    t0 = time.perf_counter()
    one = TTLPredictor(resolve_classnames("I"), TTLConfig(
        sample_batch=2, test_sets="I"), device=torch.device("cuda:0"))
    want = one.predict(images)
    del one
    one_s = time.perf_counter() - t0
    bound = MODEL_AXIS_BOUND_REL["logits"]
    out = {}
    for shape in ("2", "1,2"):
        port, master = int(free_port()), free_port()
        envs = [{"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": master}
                for r in range(2)]
        start = time.perf_counter()
        ranks = serve_ranks(shape, envs, port)
        try:
            ranks[0][2].wait(600)
            if not any("serving on" in ln for ln in ranks[0][1]):
                raise AssertionError(f"serve --mesh_shape {shape} did not "
                                     "come up:\n" + "\n".join(
                                         ranks[0][1][-40:] + ranks[1][1][-40:]))
            ready_s = time.perf_counter() - start
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as ex:
                results = list(ex.map(lambda b: http(port, "/predict", b),
                                      bodies))
            burst_s = time.perf_counter() - t0
            ranks[0][0].send_signal(signal.SIGTERM)
            codes = [p.wait(timeout=120) for p, _, _ in ranks]
        finally:
            for p, _, _ in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        err = 0.0
        for (code, got), ref in zip(results, want):
            if code != 200 or got["label"] != ref["label"] \
                    or got["zero_shot_label"] != ref["zero_shot_label"]:
                raise AssertionError(f"serve --mesh_shape {shape}: answered "
                                     f"{code} {got} where one process "
                                     f"answered {ref}")
            p_got = np.array([t["prob"] for t in got["topk"]])
            p_want = np.array([t["prob"] for t in ref["topk"]])
            err = max(err, relative_error(p_got, p_want))
        drained = any("draining" in ln for ln in ranks[0][1])
        log(f"serve --mesh_shape {shape} over two ranks on cuda:0: ready in "
            f"{ready_s:.3f} s, the burst of 8 in {burst_s:.3f} s, the one "
            f"process's labels and zero-shot labels, top-5 probabilities "
            f"within {err:.3e} of the largest (bound {bound:.3e}); SIGTERM: "
            f"exit codes {codes}, rank 0 drained: {drained}; rank 1's last "
            f"line: {ranks[1][1][-1:]}")
        if err > bound or codes != [0, 0] or not drained:
            raise AssertionError(f"serve --mesh_shape {shape} failed")
        out[shape] = {"ready_s": ready_s, "burst_s": burst_s,
                      "prob_err": err}
    log(f"serve over ranks: the one-process predictor took {one_s:.1f} s "
        f"with its set-up")
    return out


def phase_tools(build_dir) -> dict:
    """The tools: `tools/torch_quant_fidelity.py --samples 16` at
    ViT-B/16 (its JSON line: flip rate, top-5 overlap and logit deviation of
    the int8 prefix at random weights, on the card); and
    `tools/torch_convert_checkpoint.py` on phase 26's seeded fp16 OpenAI
    RN50 `.pt`, as a user runs it: every leaf of the `.npz` it writes equals
    the checkpoint's as `load_checkpoint` reads it, bit for bit."""
    import importlib.util
    import tempfile
    from ttl_tpu_torch.models.convert import load_checkpoint, load_pytree
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_quant_fidelity",
        os.path.join(root, "tools", "torch_quant_fidelity.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    t0 = time.perf_counter()
    fidelity = tool.main(["--samples", "16", "--classes", "200"])
    fidelity_s = time.perf_counter() - t0
    if fidelity["samples"] != 16 or not 0 <= fidelity["top1_flip_rate"] <= 1:
        raise AssertionError(f"quant fidelity: {fidelity}")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, np.asarray(tree)

    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        pt, npz = os.path.join(tmp, "rn50.pt"), os.path.join(tmp, "rn50.npz")
        torch.save(openai_rn_state_dict(seeded_weights("RN50", SEED + 31)),
                   pt)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "tools/torch_convert_checkpoint.py",
                              pt, "--out", npz], cwd=root,
                             capture_output=True, text=True, timeout=600)
        convert_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"convert: {run.stderr[-3000:]}")
        got = dict(leaves(load_pytree(npz)))
        want = dict(leaves(load_checkpoint(pt)[0]))
    same = got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in got)
    log(f"tools: torch_quant_fidelity at ViT-B/16 over 16 samples "
        f"{json.dumps(fidelity)} in {fidelity_s:.1f} s; "
        f"torch_convert_checkpoint on the seeded RN50 .pt: "
        f"{run.stdout.strip()} in {convert_s:.1f} s, {len(got)} leaves "
        f"{'bit for bit' if same else 'DIFFER from'} the checkpoint's")
    if not same:
        raise AssertionError("convert: the .npz is not the checkpoint")
    return {"fidelity": fidelity}



# launches a step of bench_torch.py's stages at ViT-B/16 (and of
# torch_bench_arches.py's ViT-B/32 row: 12 layers, the same window)
BENCH_LAUNCHES = {"K1": 15, "K2": 3, "K5": 0, **K6_PREFIX}
BENCH_INT8_LAUNCHES = {"K1": 15, "K2": 3, "K5": 54, "K6": 0, "K6 linear": 0}


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def run_script(argv: list, timeout: float = 900) -> tuple:
    """A script of this checkout in a process of its own: (its one JSON
    line, seconds); raises unless it exits 0 with exactly one."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *argv], cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    lines = json_lines(run.stdout)
    if run.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{argv[0]} exited {run.returncode} with "
                             f"{len(lines)} JSON lines:\n{run.stdout[-2000:]}"
                             f"\n{run.stderr[-4000:]}")
    return lines[0], seconds


def check_bench_line(out: dict, stages: dict) -> None:
    """bench_torch.py's line: a rate, the card, no stage skipped or cut by
    the watchdog, and each stage's launches a step."""
    if not out["value"] > 0 or "H100" not in out["device"]["name"]:
        raise AssertionError(f"bench_torch: {out}")
    if "skipped_stages" in out or "watchdog_timeout" in out:
        raise AssertionError(f"bench_torch: a stage was left out: {out}")
    if out["launches"] != stages:
        raise AssertionError(f"bench_torch: launches {out['launches']}, "
                             f"expected {stages}")


def phase_bench() -> dict:
    """`python3 bench_torch.py` at its defaults (ViT-B/16, S = 10, 200 and
    1000 classes, the int8 prefix) as a user runs it: its one JSON line,
    echoed here, with a rate, the H100's name, every stage's figures and
    the launches a step of each stage."""
    out, seconds = run_script(["bench_torch.py"])
    log(f"bench_torch.py in {seconds:.1f} s: {json.dumps(out)}")
    check_bench_line(out, {"headline": BENCH_LAUNCHES,
                           "1000_classes": BENCH_LAUNCHES,
                           "int8_prefix": BENCH_INT8_LAUNCHES})
    for key in ("busy_equivalent_sps", "value_1000_classes",
                "busy_1000_classes_sps", "value_int8_prefix",
                "busy_int8_prefix_sps"):
        if not out.get(key, 0) > 0:
            raise AssertionError(f"bench_torch: no {key}: {out}")
    return {"bench": out, "seconds": seconds}


def phase_bench_tools() -> dict:
    """`tools/torch_bench_arches.py --rows ViT-B/32` (wall and busy rates,
    15 K1 and 3 K2 a step) and `tools/torch_bench_host_loader.py` over 256
    synthetic JPEGs (the PIL host rate, and the native decoder's where the
    host has libjpeg)."""
    arches, arches_s = run_script(["tools/torch_bench_arches.py", "--rows",
                                   "ViT-B/32"])
    (row,) = arches["rows"]
    log(f"torch_bench_arches --rows ViT-B/32 in {arches_s:.1f} s: "
        f"{json.dumps(arches)}")
    if not (row["wall_sps"] > 0 and row.get("busy_sps", 0) > 0
            and row["launches"] == BENCH_LAUNCHES):
        raise AssertionError(f"torch_bench_arches: {row}")
    loader, loader_s = run_script(["tools/torch_bench_host_loader.py",
                                   "--n", "256"])
    log(f"torch_bench_host_loader --n 256 in {loader_s:.1f} s: "
        f"{json.dumps(loader)}")
    # the native decoder needs libjpeg on the host: where it is missing the
    # loader takes PIL, and the line says so
    if not (loader["pil_sps"] > 0 and (loader.get("native_sps", 0) > 0
                                       or not loader["native_available"])):
        raise AssertionError(f"torch_bench_host_loader: {loader}")
    return {"arches": arches, "loader": loader}


def phase_bench_ranks(build_dir) -> dict:
    """`bench_torch.py` as two processes on cuda:0 (RANK 0 and 1,
    WORLD_SIZE 2, LOCAL_RANK 0, gloo; TTL_BENCH_S=2): the aggregate stage
    runs the step split over the ranks, 2 samples on each; rank 0 alone
    prints, with `aggregate_sps`, `per_chip_sps`, `device_count` 2 and the
    aggregate's launches (15 K1, 3 K2 a step on each rank)."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "WORLD_SIZE": "2", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": free_port(),
           "TTL_BENCH_S": "2"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.{k}"), "w+")
                for r in range(2) for k in ("out", "err")]
        procs = [subprocess.Popen(
            [sys.executable, "bench_torch.py"], cwd=root,
            env={**env, "RANK": str(r)}, stdout=logs[2 * r],
            stderr=logs[2 * r + 1]) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=900)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    seconds = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"bench_torch rank {r} exited "
                                 f"{p.returncode}:\n{texts[2 * r + 1][-4000:]}")
    lines = [json_lines(texts[0]), json_lines(texts[2])]
    if len(lines[0]) != 1 or lines[1]:
        raise AssertionError(f"bench_torch ranks printed {lines}")
    out = lines[0][0]
    log(f"bench_torch.py over two ranks on cuda:0 in {seconds:.1f} s: "
        f"{json.dumps(out)}")
    check_bench_line(out, {"headline": BENCH_LAUNCHES,
                           "1000_classes": BENCH_LAUNCHES,
                           "aggregate": BENCH_LAUNCHES,
                           "int8_prefix": BENCH_INT8_LAUNCHES})
    if not (out["aggregate_sps"] > 0 and out["device_count"] == 2
            and out["device"]["ranks"] == 2):
        raise AssertionError(f"bench_torch ranks: {out}")
    return {"bench": out, "seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ttl_tpu_torch.ops import _build
    from ttl_tpu_torch.ops import attention as fa
    from ttl_tpu_torch.ops import layer_norm as tln
    from ttl_tpu_torch.ops import ln_matmul as tlm
    from ttl_tpu_torch.ops import quant as tq
    from ttl_tpu_torch.ops import swiglu as tsw

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
                           {"K1": 15, "K2": 3, "K5": 0, **K6_PREFIX},
                           (LN_TEXT, LN_MAIN))
    main_fp = phase_card_vs_cpu(config(), "main path", "main path")
    other = phase_other_geometries(fa)
    k5 = phase_k5(tq)
    int8_path = phase_path(fa, tq, "int8 main path",
                           config("--prefix_quant", "int8"),
                           {"K1": 15, "K2": 3, "K5": 54},
                           (LN_TEXT, LN_MAIN + 18))
    zero_shot = phase_path(fa, tq, "zero-shot",
                           config("--tta_steps", "0", "--prefix_quant",
                                  "int8", "--ensemble"),
                           {"K1": 12, "K2": 0, "K5": 72},
                           # the ensemble's text tower over 200 classes x
                           # 80 templates, 256 prompts a call
                           (LN_TEXT * -(-200 * 80 // 256), 2 + 24))
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
                               {"K3 fwd": 36, "K3 bwd": 3, **K6_TOWER},
                               (0, 58))
        _, text_cpu = phase_card_vs_cpu(text_cfg, "text-LoRA, per_head route",
                                        "text-LoRA")
    with attention_route(fa, "heads"):
        prompt_path = phase_path(fa, tq, "prompt tuning, heads route",
                                 prompt_cfg, {"K4 fwd": 60, "K4 bwd": 12,
                                              **K6_TOWER}, (0, 126))
        _, prompt_cpu = phase_card_vs_cpu(prompt_cfg,
                                          "prompt tuning, heads route",
                                          "prompt tuning")
    log_einsum_yardstick(fa, text_cfg, "text-LoRA", text_cpu)
    log_einsum_yardstick(fa, prompt_cfg, "prompt tuning", prompt_cpu)
    tpt_lora_cfg = config("--deyo_selection", "False")
    tpt_lora = phase_path(fa, tq, "TPT on LoRA", tpt_lora_cfg,
                          {"K1": 18, "K2": 3, **K6_PREFIX},
                          (LN_TEXT, LN_MAIN + 7), timed=False)
    phase_card_vs_cpu(tpt_lora_cfg, "TPT on LoRA", "TPT on LoRA")
    k6 = phase_k6(tlm)
    cocoop_cfg = config("--cocoop")
    cocoop_path = phase_path(fa, tq, "CoCoOp", cocoop_cfg,
                             {"K1": 12, "K6": 48}, (0, 151))
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
    for phase, run in ((31, lambda: phase_profile(
                            fa, tq, lib.parent, main_path["samples_per_s"])),
                       (32, phase_analysis),
                       (33, lambda: phase_data_parallel(lib.parent))):
        start = time.perf_counter()
        seconds[phase] = (run(), time.perf_counter() - start)
        log(f"phase {phase} took {seconds[phase][1]:.1f} s")
    for phase, run in ((34, lambda: phase_model_axis(lib.parent)),
                       (35, phase_serve_ranks),
                       (36, lambda: phase_tools(lib.parent))):
        start = time.perf_counter()
        seconds[phase] = (run(), time.perf_counter() - start)
        log(f"phase {phase} took {seconds[phase][1]:.1f} s")
    for phase, run in ((37, phase_bench), (38, phase_bench_tools),
                       (39, lambda: phase_bench_ranks(lib.parent)),
                       (40, lambda: phase_swiglu(tsw)),
                       (41, lambda: phase_layer_norm(tln)),
                       (42, lambda: phase_mlp_stride(tln)),
                       (43, lambda: phase_aimv2(fa, tq, tlm, tln, tsw))):
        start = time.perf_counter()
        seconds[phase] = (run(), time.perf_counter() - start)
        log(f"phase {phase} took {seconds[phase][1]:.1f} s")
    predict_runs, served, bongard_runs = (seconds[p][0] for p in (27, 29, 30))
    profile_run, _, data_parallel = (seconds[p][0] for p in (31, 32, 33))
    model_axis, served_ranks, tools = (seconds[p][0] for p in (34, 35, 36))
    log(f"new paths: predict {predict_runs['predict']['samples_per_s']:.3f} "
        f"images/s at {100 * predict_runs['predict']['busy_share']:.1f}% "
        f"busy; serve ready in {served['ready_s']:.3f} s, first answer in "
        f"{served['first_response_s']:.3f} s; Bongard adapted "
        f"{bongard_runs['Bongard']['images_per_s']:.3f} images/s at "
        f"{100 * bongard_runs['Bongard']['busy_share']:.1f}% busy; phases "
        f"27-30 took {sum(seconds[p][1] for p in (27, 28, 29, 30)):.1f} s; "
        f"--profile {profile_run['samples_per_s']:.3f} samples/s against "
        f"the main path's {main_path['samples_per_s']:.3f}; the data-parallel "
        f"steady s/batch {data_parallel.pop('pace')}; phases 31-33 took "
        f"{sum(seconds[p][1] for p in (31, 32, 33)):.1f} s; the model axis "
        f"s/batch {model_axis['pace']}, its collectives' host ms a batch "
        f"{model_axis['model_ms']}, against one process: "
        f"{model_axis['errors']}; serve over two ranks {served_ranks}; "
        f"quant fidelity {tools['fidelity']}; phases 34-36 took "
        f"{sum(seconds[p][1] for p in (34, 35, 36)):.1f} s; bench_torch "
        f"{seconds[37][0]['bench']['value']} samples/s at S = 10 against "
        f"phase 4's {main_path['samples_per_s']:.3f} at S = 8; phases 37-39 "
        f"took {sum(seconds[p][1] for p in (37, 38, 39)):.1f} s")
    paths = {"main path": main_path, "int8 main path": int8_path,
             "zero-shot": zero_shot, "text-LoRA (per_head)": text_path,
             "prompt tuning (heads)": prompt_path, "CoCoOp": cocoop_path,
             "PLPD": plpd_path, "AugMix": augmix_path,
             "RN50 prompt tuning (heads)": rn50_tpt,
             "RN50 zero-shot": rn50_zero_shot,
             "predict": predict_runs.pop("predict"),
             "AIMv2-L/14": seconds[43][0].pop("path")}
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
    paths["--profile"] = profile_run
    paths.update({f"data-parallel, {name}": r
                  for name, r in data_parallel.items()})
    paths.update({f"model axis, {name}": {"launches": launches}
                  for name, launches in model_axis["launches"].items()})

    def by_path(key):
        return {name: r["launches"][key] for name, r in paths.items()}

    src = "ttl_tpu_torch/csrc/attention_bshd.cu"
    bhsd_src = "ttl_tpu_torch/csrc/attention_bhsd.cu"
    fc1 = k5[K5_FC1]
    k6_fc1 = k6[K6_FC1]
    swiglu = seconds[40][0]
    ln_results = seconds[41][0]
    mlp = seconds[42][0]
    aim = seconds[43][0]
    ln_by_path = {name: r["layer_norm"] for name, r in paths.items()
                  if "layer_norm" in r}
    log(f"layernorm launches over each path's run of 16 images: "
        f"{ln_by_path}")

    def other_shapes(kind):
        """K1's or K2's results at OTHER_FWD / OTHER_BWD, by shape."""
        return {f"[{b}, {s}, {w}] {d}": other[(kind, s, w, d)]
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
         "linear_launches": main_path["launches"]["K6 linear"],
         **{**k6_fc1,
            "max_abs_err": max(r["max_abs_err"] for r in k6.values()),
            "linear_max_abs_err": max(r["linear_max_abs_err"]
                                      for r in k6.values())},
         "launches_by_path": by_path("K6"),
         "linear_launches_by_path": by_path("K6 linear"),
         "shapes": {f"[{m}, {k}] x [{k}, {n}] {d}": r
                    for (m, k, n, d), r in k6.items()}},
        {"name": "swiglu", "route": "cuda",
         "source": "ttl_tpu_torch/csrc/swiglu.cu",
         "replaces": "none (EVA02's gated MLP)", **swiglu[SWIGLU_STEP],
         "max_abs_err": max(r["max_abs_err"] for r in swiglu.values()),
         "shapes": {f"[{m}, 2 x {f}] {d}": r
                    for (m, f, d), r in swiglu.items()},
         "mlp_products": {f"{name} at {fp}": r
                          for key, r in mlp.items() if key != "layer_norm"
                          for name, fp in (key,)}},
        {"name": "layer_norm", "route": "cuda",
         "source": "ttl_tpu_torch/csrc/layer_norm.cu",
         "replaces": "none (XLA's fused layernorm)",
         **ln_results[LN_STEP_SHAPES[0]],
         "max_abs_err": max(r["max_abs_err"] for r in ln_results.values()),
         "launches_by_path": ln_by_path,
         "shapes": {f"[{m}, {k}] {d}": r
                    for (m, k, d), r in ln_results.items()},
         "strided": {f"[{MLP_ROWS}, {MLP_FP}] bf16 at width {MLP_F}":
                     mlp["layer_norm"]}},
        {"name": "aimv2", "route": "cuda",
         "source": "attention_bshd.cu, layer_norm.cu, ln_matmul.cu",
         "replaces": "none (AIMv2-L/14's head dim 128 and RMS statistics)",
         "shapes": aim,
         "rms_launches_by_path": by_path("K6 RMS")},
    ]
    print(json.dumps({"kernels": kernels}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
