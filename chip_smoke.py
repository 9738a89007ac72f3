"""Smoke run of the PyTorch port (ttl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, then:

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
   through the plain path on the CPU, same weights and view draws.

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
# 4 bf16 ulps of the largest gradient (2^-8 relative each).
BWD_BOUND_REL = 4 * 2.0 ** -8
# card (bf16, kernels, cuBLAS) against CPU (bf16, plain version): both round
# every activation to bf16 but accumulate in different orders through 12
# layers, a backward and an AdamW step. Logits are 100 x a cosine; with
# random weights |logits| < 2, where one bf16 ulp is 2^-7 = 0.0078, and the
# bound is about 6 such ulps.
CARD_CPU_BOUND = 0.05


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


def inputs(b: int, dtype, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, SEQ_PAD, WIDTH, generator=g).to("cuda", dtype)
            for _ in range(n)]


def phase_forward(fa) -> dict:
    results = {}
    for b, dtype in [(512, torch.bfloat16), (8, torch.bfloat16),
                     (8, torch.float32)]:
        q, k, v = inputs(b, dtype, 3, seed=b)
        out = fa.bshd_forward_cuda(q, k, v, HEADS, SEQ)
        ref = fa.attention_bshd_plain(q, k, v, HEADS, SEQ)
        torch.cuda.synchronize()
        err = (out.float() - ref.float())[:, :SEQ].abs().max().item()
        bound = FWD_BOUND[dtype] * max(1.0, ref.float().abs().max().item())
        ms = median_ms(lambda: fa.bshd_forward_cuda(q, k, v, HEADS, SEQ))
        plain_ms = median_ms(
            lambda: fa.attention_bshd_plain(q, k, v, HEADS, SEQ))
        log(f"K1 [{b}, {SEQ_PAD}, {WIDTH}] {dtype}: max_abs_err {err:.3e} "
            f"(bound {bound:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            "ms")
        if not err <= bound:
            raise AssertionError(f"K1 disagrees with its plain version: {err}"
                                 f" > {bound}")
        results[(b, dtype)] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms}
    return results[(512, torch.bfloat16)]


def phase_backward(fa) -> dict:
    q, k, v, do = inputs(512, torch.bfloat16, 4, seed=7)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.attention_bshd_plain(*leaves, HEADS, SEQ)
    want = torch.autograd.grad(out, leaves, do, retain_graph=True)
    got = fa.bshd_backward_cuda(q, k, v, do, HEADS, SEQ)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"K2 {name} is not finite")
        err = (g.float() - w.float())[:, :SEQ].abs().max().item()
        bound = BWD_BOUND_REL * w.float().abs().max().item()
        log(f"K2 {name}: max_abs_err {err:.3e} (bound {bound:.3e})")
        if not err <= bound:
            raise AssertionError(f"K2 {name} disagrees with autograd through "
                                 f"the plain version: {err} > {bound}")
        worst = max(worst, err)
    ms = median_ms(lambda: fa.bshd_backward_cuda(q, k, v, do, HEADS, SEQ))
    plain_ms = median_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    log(f"K2 [512, {SEQ_PAD}, {WIDTH}] bf16: kernel {ms:.4f} ms, plain "
        f"(autograd backward) {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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


def default_config():
    """The configuration of `python -m ttl_tpu_torch DATA --test_sets A`:
    ViT-B/16, every TTL flag at its default."""
    from ttl_tpu_torch.cli import build_parser, config_from_args
    return config_from_args(build_parser().parse_args(
        ["synthetic", "--test_sets", "A", "--seed", str(SEED)]))


class StepProbe:
    """Stands in for runner.make_fused_ttl_fn. It wraps the fused step,
    records the host clock as each step is dispatched and keeps each batch's
    logits for `check` after the run: checking them inside would wait for
    the device and empty the runner's pipeline. With `profile`, each step
    runs under torch.profiler and is waited for."""

    def __init__(self, make_fused, profile: bool = False):
        self.make_fused, self.profile = make_fused, profile
        self.starts, self.logits = [], []
        self.table = self.busy_ms = None

    def __call__(self, clip_cfg, cfg):
        fused = self.make_fused(clip_cfg, cfg)

        def step(*args):
            self.starts.append(time.perf_counter())
            if self.profile:
                res = self._profiled(fused, args)
            else:
                res = fused(*args)
            self.logits.append(res.logits)
            return res

        return step

    def _profiled(self, fused, args):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = fused(*args)
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


def phase_main_path(fa) -> dict:
    from ttl_tpu_torch import runner

    cfg = default_config()
    original = runner.make_fused_ttl_fn

    def drive(probe, n_images):
        runner.make_fused_ttl_fn = probe
        try:
            res = runner.run(cfg, device=torch.device("cuda"),
                             datasets={"A": SyntheticImages(n_images)})
        finally:
            runner.make_fused_ttl_fn = original
        probe.check(cfg.sample_batch, 200)
        return res

    probe = StepProbe(original)
    start = time.perf_counter()
    fa.reset_launch_counts()
    res = drive(probe, 16)
    fwd, bwd = fa.attention_bshd.fwd_launches, fa.attention_bshd.bwd_launches
    n_batches = len(probe.starts)
    log(f"main path: {n_batches} batches, K1 launches {fwd}, K2 launches "
        f"{bwd}, top1/top5 {res['A']}, whole run "
        f"{time.perf_counter() - start:.1f} s")
    if n_batches != 2 or (fwd, bwd) != (15 * n_batches, 3 * n_batches):
        raise AssertionError(f"expected 15 K1 and 3 K2 launches per batch, "
                             f"got {fwd} and {bwd} over {n_batches} batches")
    top1, top5 = res["A"]
    if not (0.0 <= top1 <= 100.0 and 0.0 <= top5 <= 100.0):
        raise AssertionError(f"top-1/top-5 out of range: {res['A']}")

    # throughput: a longer run through the runner's own pipeline. Once
    # pipeline_depth + 1 steps are queued, each dispatch waits for an older
    # step's counts, so the dispatch clock ticks at the steady batch rate.
    timing = StepProbe(original)
    drive(timing, 80)
    pace = np.diff(timing.starts[cfg.pipeline_depth + 1:])
    log(f"steady state: {len(pace)} batches of {cfg.sample_batch} samples, "
        f"s/batch {pace.tolist()}, median {np.median(pace):.4f} s, samples/s "
        f"{cfg.sample_batch / np.median(pace):.3f} (pipeline_depth "
        f"{cfg.pipeline_depth})")

    profiled = StepProbe(original, profile=True)
    drive(profiled, cfg.sample_batch)
    busy_s = profiled.busy_ms / 1e3
    log(f"one batch under torch.profiler: device busy {busy_s:.4f} s, "
        f"{100 * busy_s / np.median(pace):.1f}% of the steady s/batch; top "
        f"CUDA kernels:\n{profiled.table}")
    return {"fwd": fwd, "bwd": bwd}


def phase_card_vs_cpu() -> None:
    from ttl_tpu_torch import runner
    from ttl_tpu_torch.adapt.ttl import make_fused_ttl_fn
    from ttl_tpu_torch.models.clip import tree_map
    from ttl_tpu_torch.ops.image import draw_batch

    cfg = default_config()
    dev = torch.device("cuda")
    clip_cfg, params = runner.load_model(cfg, dev)
    adapters0 = runner.make_adapters0(cfg, clip_cfg, dev)
    text_cls = runner.text_classifier("A", cfg, clip_cfg, params, device=dev)
    rng = np.random.default_rng(SEED + 1)
    canvas = np.zeros((1, 256, 256, 3), np.uint8)
    canvas[0, :200, :256] = rng.integers(0, 256, (200, 256, 3),
                                         dtype=np.uint8)
    host = {"canvases": torch.from_numpy(canvas),
            "hs": torch.tensor([200]), "ws": torch.tensor([256]),
            "draws": draw_batch(cfg.seed, [3], cfg.batch_size)}
    fused = make_fused_ttl_fn(clip_cfg, cfg)

    def run_on(device):
        def put(t):
            return t.to(device)
        return fused(tree_map(put, params), put(text_cls),
                     tree_map(put, adapters0), put(host["canvases"]),
                     put(host["hs"]), put(host["ws"]),
                     tree_map(put, host["draws"])).logits[0].float().cpu()

    card = run_on(dev)
    t0 = time.perf_counter()
    cpu = run_on(torch.device("cpu"))
    diff = (card - cpu).abs().max().item()
    log(f"card vs CPU: top-1 {int(card.argmax())} vs {int(cpu.argmax())}, "
        f"max_abs_diff {diff:.4f} (bound {CARD_CPU_BOUND}), logits range "
        f"[{cpu.min().item():.3f}, {cpu.max().item():.3f}], CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    if int(card.argmax()) != int(cpu.argmax()) or not diff <= CARD_CPU_BOUND:
        raise AssertionError("card and CPU disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ttl_tpu_torch.ops import _build
    from ttl_tpu_torch.ops import attention as fa

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
    counts = phase_main_path(fa)
    phase_card_vs_cpu()

    src = "ttl_tpu_torch/csrc/attention_bshd.cu"
    kernels = [
        {"name": "bshd_attention_fwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:431", "launches": counts["fwd"],
         **fwd},
        {"name": "bshd_attention_bwd", "route": "cuda", "source": src,
         "replaces": "ttl_tpu/ops/attention.py:482", "launches": counts["bwd"],
         **bwd},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
