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
   does, so a card run that skipped the int8 layers fails.

Any failed phase raises, and the script exits non-zero without its result
line. Without CUDA it exits non-zero at once. The second-to-last lines are a
JSON object of kernel results and the card's nvidia-smi line; the last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
        results[(k, n, dtype)] = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms,
                                  "linear_ms": linear_ms}
        del x, got, want
    return results


class SyntheticImages:
    """In-memory dataset of uint8 [H, W, 3] images of several sizes, with the
    interface of the JAX package's ArrayDataset that the loader reads."""

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
    """Stands in for the runner's step factory (make_fused_ttl_fn or
    make_fused_zeroshot_fn). It wraps the step, records the host clock as
    each step is dispatched and keeps each batch's logits for `check` after
    the run: checking them inside would wait for the device and empty the
    runner's pipeline. With `profile`, each step runs under torch.profiler
    and is waited for."""

    def __init__(self, make_step, profile: bool = False):
        self.make_step, self.profile = make_step, profile
        self.starts, self.logits = [], []
        self.table = self.busy_ms = None

    def __call__(self, clip_cfg, cfg):
        step_fn = self.make_step(clip_cfg, cfg)

        def step(*args):
            self.starts.append(time.perf_counter())
            if self.profile:
                res = self._profiled(step_fn, args)
            else:
                res = step_fn(*args)
            self.logits.append(getattr(res, "logits", res))
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
    return {"K1": fa.attention_bshd.fwd_launches,
            "K2": fa.attention_bshd.bwd_launches, "K5": tq.linear_q.launches}


def reset_counts(fa, tq) -> None:
    fa.reset_launch_counts()
    tq.linear_q.launches = 0


def phase_path(fa, tq, name: str, cfg, per_batch: dict) -> dict:
    """Drive runner.run over 16 images and check the launches per batch,
    then time 80 images in steady state and profile one batch."""
    from ttl_tpu_torch import runner

    attr = "make_fused_ttl_fn" if cfg.tta_steps > 0 else \
        "make_fused_zeroshot_fn"
    original = getattr(runner, attr)

    def drive(probe, n_images):
        setattr(runner, attr, probe)
        try:
            res = runner.run(cfg, device=torch.device("cuda"),
                             datasets={"A": SyntheticImages(n_images)})
        finally:
            setattr(runner, attr, original)
        probe.check(cfg.sample_batch, 200)
        return res

    probe = StepProbe(original)
    start = time.perf_counter()
    reset_counts(fa, tq)
    res = drive(probe, 16)
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

    # throughput: a longer run through the runner's own pipeline. Once
    # pipeline_depth + 1 steps are queued, each dispatch waits for an older
    # step's counts, so the dispatch clock ticks at the steady batch rate.
    timing = StepProbe(original)
    drive(timing, 80)
    pace = np.diff(timing.starts[cfg.pipeline_depth + 1:])
    rate = cfg.sample_batch / np.median(pace)
    log(f"{name} steady state: {len(pace)} batches of {cfg.sample_batch} "
        f"samples, s/batch {pace.tolist()}, median {np.median(pace):.4f} s, "
        f"samples/s {rate:.3f} (pipeline_depth {cfg.pipeline_depth})")

    profiled = StepProbe(original, profile=True)
    drive(profiled, cfg.sample_batch)
    busy_s = profiled.busy_ms / 1e3
    log(f"{name}, one batch under torch.profiler: device busy {busy_s:.4f} "
        f"s, {100 * busy_s / np.median(pace):.1f}% of the steady s/batch; "
        f"top CUDA kernels:\n{profiled.table}")
    return {"launches": counts, "samples_per_s": rate}


def sample_step(cfg):
    """run_on(device) -> one fixed sample's logits through `cfg`'s path,
    with weights made on the card and moved to `device`."""
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt.ttl import (make_fused_ttl_fn,
                                         make_fused_zeroshot_fn)
    from ttl_tpu_torch.models.clip import tree_map
    from ttl_tpu_torch.ops.image import draw_batch

    dev = torch.device("cuda")
    clip_cfg, params = runner.load_model(cfg, dev)
    text_cls = runner.text_classifier("A", cfg, clip_cfg, params, device=dev)
    rng = np.random.default_rng(SEED + 1)
    canvas = np.zeros((1, 256, 256, 3), np.uint8)
    canvas[0, :200, :256] = rng.integers(0, 256, (200, 256, 3),
                                         dtype=np.uint8)
    host = {"canvases": torch.from_numpy(canvas),
            "hs": torch.tensor([200]), "ws": torch.tensor([256])}
    if cfg.tta_steps > 0:
        adapters0 = runner.make_adapters0(cfg, clip_cfg, dev)
        draws = draw_batch(cfg.seed, [3], cfg.batch_size)
        fused = make_fused_ttl_fn(clip_cfg, cfg)

        def step(put):
            return fused(tree_map(put, params), put(text_cls),
                         tree_map(put, adapters0), put(host["canvases"]),
                         put(host["hs"]), put(host["ws"]),
                         tree_map(put, draws)).logits
    else:
        zeroshot = make_fused_zeroshot_fn(clip_cfg, cfg)

        def step(put):
            return zeroshot(tree_map(put, params), put(text_cls),
                            put(host["canvases"]), put(host["hs"]),
                            put(host["ws"]))

    def run_on(device):
        return step(lambda t: t.to(device))[0].float().cpu()

    return run_on


def card_and_cpu(cfg):
    """One sample through the CUDA path and through the plain path on the
    CPU, same weights (made, and quantised, on the card) and view draws:
    (card logits, CPU logits, CPU seconds)."""
    run_on = sample_step(cfg)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ttl_tpu_torch.ops import _build
    from ttl_tpu_torch.ops import attention as fa
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
    log(f"steady samples/s: main path {main_path['samples_per_s']:.3f}, "
        f"int8 main path {int8_path['samples_per_s']:.3f}, zero-shot "
        f"{zero_shot['samples_per_s']:.3f}")

    def by_path(key):
        return {"main path": main_path["launches"][key],
                "int8 main path": int8_path["launches"][key],
                "zero-shot": zero_shot["launches"][key]}

    src = "ttl_tpu_torch/csrc/attention_bshd.cu"
    fc1 = k5[(768, 3072, torch.bfloat16)]
    kernels = [
        {"name": "bshd_attention_fwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:431",
         "launches": main_path["launches"]["K1"], **fwd,
         "launches_by_path": by_path("K1"),
         "key_tiled": {f"[16, {s}, 1024] {d}": r
                       for (kind_, s, d), r in tiled.items()
                       if kind_ == "fwd"}},
        {"name": "bshd_attention_bwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:482",
         "launches": main_path["launches"]["K2"], **bwd,
         "launches_by_path": by_path("K2"),
         "key_tiled": {f"[16, {s}, 1024] {d}": r
                       for (kind_, s, d), r in tiled.items()
                       if kind_ == "bwd"}},
        {"name": "quant_matmul", "route": "cuda",
         "source": "ttl_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "ttl_tpu/ops/quant_matmul.py:42",
         "launches": int8_path["launches"]["K5"],
         "max_abs_err": max(r["max_abs_err"] for r in k5.values()),
         "ms": fc1["ms"], "plain_ms": fc1["plain_ms"],
         "launches_by_path": by_path("K5"),
         "shapes": {f"[{K5_ROWS}, {k}] x [{k}, {n}] {d}": r
                    for (k, n, d), r in k5.items()}},
    ]
    print(json.dumps({"kernels": kernels}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
