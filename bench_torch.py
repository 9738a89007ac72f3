#!/usr/bin/env python
"""TTL benchmark on the PyTorch port: adapted samples/s/card for the 64-view
TTL step, the counterpart of bench.py.

Measures the default TTL configuration (CLIP ViT-B/16, 64 views = 1 clean +
63 random-resized-crop/flip, LoRA r=16 alpha=32 on vision layers 9-11, DeYO
entropy-reweighted loss, one AdamW step lr 5e-3, episodic reset, adapted
clean-view inference) as the runner dispatches it: the host draws of a
batch (`runner.sample_draws`), the fused step (uint8 canvases -> views on
the card -> episodic adaptation -> adapted logits, K1/K2 in every vision
layer) and the top-k counts on the card. Weights are random (seed 0);
throughput does not depend on them.

One result line, JSON, exactly once. Its stages, in order:

  value                    best-window wall samples/s at 200 classes (the
                           first 2 steps give a provisional figure first);
  device_busy_ms_per_step  device time of a step from a torch.profiler
  busy_equivalent_sps      trace (kernels, copies, memsets), and S over it;
  value_1000_classes       the same step at 1000 classes, with its busy rate;
  aggregate_sps            under several processes (python -m
  per_chip_sps             torch.distributed.run --nproc_per_node N
  device_count             bench_torch.py): the step sharded over the ranks,
                           S samples on each; rank 0 alone prints;
  value_int8_prefix        `--prefix_quant int8` (K5 on the 9 frozen layers),
                           with its busy rate;
  skipped_stages           what TTL_BENCH_BUDGET_S (default 780 s) left out.

`device` names the card, its power limit (nvidia-smi) and the number of
ranks; `launches` holds the kernel launches of the first step of each
stage. On the default attention route a card run checks them (ViT-B/16: K1
15 and K2 3 a step, K6 36 with `linear`'s epilogue in the frozen prefix,
and in the int8 stage K5 54 and K6 0) and fails otherwise: no stage gives
way to a plain version.

A watchdog thread prints what was measured, with "watchdog_timeout": true,
once the run is TTL_BENCH_WATCHDOG_GRACE_S (default 60 s) past its budget,
and exits 0; if nothing was measured it says so on stderr and exits 1.

Environment: TTL_BENCH_S (samples a step, default 10), TTL_BENCH_ARCH
(default ViT-B/16), TTL_BENCH_BUDGET_S, TTL_BENCH_WATCHDOG_GRACE_S, and
TTL_BENCH_PLATFORM: unset or `cuda` runs on the card and fails without one;
`cpu` runs the kernels' plain versions on the CPU (tests, at test-tiny).

  python3 bench_torch.py
  TTL_BENCH_PLATFORM=cpu TTL_BENCH_ARCH=test-tiny python3 bench_torch.py
"""
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ttl_tpu_torch.adapt.ttl import make_fused_ttl_fn
from ttl_tpu_torch.config import (TTLConfig, effective_update_steps,
                                  resolve_layer_range)
from ttl_tpu_torch.data.classnames import imagenet_classnames
from ttl_tpu_torch.models.clip import init_clip_params
from ttl_tpu_torch.models.prompts import build_text_classifier, prompt_tokens
from ttl_tpu_torch.models.zoo import get_arch
from ttl_tpu_torch.ops import attention as fa
from ttl_tpu_torch.ops import quant as tq
from ttl_tpu_torch.ops.ln_matmul import ln_matmul
from ttl_tpu_torch.ops.lora import init_adapters
from ttl_tpu_torch.parallel.eval import make_count_fn
from ttl_tpu_torch.parallel.mesh import (make_mesh, replicate, shard_batch,
                                         shard_params, world_and_rank)
from ttl_tpu_torch.runner import full_f32_products, sample_draws
from ttl_tpu_torch.utils.profiling import device_busy_us, trace

_PRINTED = threading.Event()
_EMIT_LOCK = threading.Lock()


def emit_once(out: dict) -> None:
    """Print the single result line exactly once: the main thread and the
    watchdog race for it, and whoever comes second prints nothing. The flag
    is set only after a successful dumps, so a failed attempt (the main
    thread changing `out` during the copy) does not suppress the line."""
    with _EMIT_LOCK:
        if _PRINTED.is_set():
            return
        line = json.dumps(out)
        _PRINTED.set()
        print(line, flush=True)


def bench_inputs(row: str, S: int, device):
    """The inputs of a benched step. `row` is ARCH, or ARCH:text for
    text-LoRA. Random bf16 weights from seed 0, adapters from seed 1 over
    the adapted tower's LoRA window, and S 512-pixel canvases holding one
    375 x 500 image each (np.random.RandomState(0)). Returns (clip_cfg,
    cfg, params, adapters0, canv, hs, ws)."""
    arch, _, mode = row.partition(":")
    clip_cfg = get_arch(arch)
    cfg = TTLConfig(arch=arch, sample_batch=S,
                    lora_encoder="text" if mode == "text" else "image",
                    resolution=clip_cfg.vision.image_size)
    params = init_clip_params(clip_cfg, torch.Generator().manual_seed(0),
                              device=device, param_dtype=torch.bfloat16)
    lo, hi = resolve_layer_range(cfg, clip_cfg)
    tower = clip_cfg.text if mode == "text" else clip_cfg.vision
    adapters0 = init_adapters(torch.Generator().manual_seed(1), hi - lo + 1,
                              tower.hidden, cfg.rank, cfg.init_method,
                              device=device)
    rng = np.random.RandomState(0)
    canv = (rng.rand(S, 512, 512, 3) * 255).astype(np.uint8)
    hs = np.full((S,), 375, np.int32)
    ws = np.full((S,), 500, np.int32)
    return clip_cfg, cfg, params, adapters0, canv, hs, ws


def class_tokens(n_classes: int) -> np.ndarray:
    """The prompt tokens of the first `n_classes` ImageNet classes."""
    return prompt_tokens(imagenet_classnames()[:n_classes])


def classifier(params, clip_cfg, n_classes: int) -> torch.Tensor:
    """The frozen text classifier of the first `n_classes` ImageNet
    classes."""
    return build_text_classifier(params["text"], class_tokens(n_classes),
                                 clip_cfg.text,
                                 device=params["logit_scale"].device)


def make_step(clip_cfg, cfg, params, text_cls, adapters0, canv, hs, ws, *,
              mesh=None, tokens=None):
    """Build the benched unit of work: one fused TTL step and its counts.

    Returns (step, S): step(i) makes the host draws of samples i*S ...
    i*S+S-1, runs the fused step on the canvases (uploaded once, here) and
    returns the [3] count tensor without waiting for it; fetching it fences
    the step. With `mesh` (the data axis over the processes) the S samples
    are split over the ranks as the runner splits a batch, each rank runs
    its rows, and the counts are summed over the ranks on the host.
    `tokens` (the class-prompt table) is needed by text-LoRA."""
    S = canv.shape[0]
    device = params["logit_scale"].device
    fused = make_fused_ttl_fn(clip_cfg, cfg, mesh=mesh, tokens=tokens)
    count_fn = make_count_fn(mesh)
    batch = (canv, hs, ws, np.zeros((S,), np.int64), np.ones((S,), bool))
    if mesh is not None:
        params = shard_params(replicate(params, mesh), mesh)
        text_cls, adapters0 = replicate((text_cls, adapters0), mesh)
        batch = shard_batch(batch, mesh)
    canv, hs, ws, labels, valid = (torch.from_numpy(a).to(device)
                                   for a in batch)
    on_card = device.type == "cuda"

    def step(i):
        idxs = np.arange(S) + i * S
        if mesh is not None:
            idxs = shard_batch(idxs, mesh)
        # pinned and non-blocking: a pageable copy would wait for the card
        draws = {k: t.pin_memory().to(device, non_blocking=True) if on_card
                 else t for k, t in sample_draws(cfg, idxs).items()}
        res = fused(params, text_cls, adapters0, canv, hs, ws, draws)
        return count_fn(res.logits, labels, valid)

    return step, S


def measure(clip_cfg, cfg, params, text_cls, adapters0, canv, hs, ws, *,
            windows=5, iters=10, mesh=None, step=None, provisional_cb=None):
    """Best-window wall samples/s of the fused TTL step.

    With `mesh` the step is split over the ranks and the rate is the
    aggregate over all of them (canv carries the S samples of every rank).
    `step` reuses a make_step step. `provisional_cb`, if given, receives a
    coarse samples/s from the 2 steps after the first, before the windows.
    Each window enqueues `iters` steps, holding only their count tensors,
    then fetches the counts and synchronises the card."""
    S = canv.shape[0]
    if step is None:
        step, S = make_step(clip_cfg, cfg, params, text_cls, adapters0,
                            canv, hs, ws, mesh=mesh)
    device = params["logit_scale"].device
    step(0).tolist()  # the first step: kernel build and allocator warm-up
    t0 = time.perf_counter()
    for p in [step(1), step(2)]:
        p.tolist()
    if provisional_cb is not None:
        provisional_cb(2 * S / max(time.perf_counter() - t0, 1e-9))
    best = float("inf")
    for w in range(windows):
        t0 = time.perf_counter()
        pending = [step(1000 * (w + 1) + i) for i in range(iters)]
        for p in pending:
            p.tolist()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return S / best


def busy_ms_for(step, device, *, steps=4, mesh=None):
    """Device-busy ms a step from a short torch.profiler trace (every
    kernel's, copy's and memset's time, `utils/profiling.py`), or None: on
    the CPU (no device events), or where the trace failed (a warning says
    why). Under `mesh` each rank traces its own card and the mean over the
    ranks is returned, as bench.py divides its devices' sum by their
    count."""
    if device.type != "cuda":
        return None
    busy_us = None
    try:
        step(7).tolist()  # warm, outside the trace
        td = tempfile.mkdtemp(prefix="ttl_bench_trace_")
        try:
            with trace(td, device):
                for p in [step(10 + i) for i in range(steps)]:
                    p.tolist()
            busy_us = device_busy_us(td) or None
        finally:
            shutil.rmtree(td, ignore_errors=True)
    except Exception as e:  # telemetry must not lose the wall figures
        print(f"WARNING: busy-time telemetry failed: {type(e).__name__}: "
              f"{e}", file=sys.stderr)
    if mesh is not None and mesh.world > 1:
        total = torch.tensor([math.nan if busy_us is None else busy_us],
                             dtype=torch.float64)
        torch.distributed.all_reduce(total)
        busy_us = total.item() / mesh.world
        if not math.isfinite(busy_us):
            return None
    return None if busy_us is None else busy_us / steps / 1000.0


def step_launches(step, i: int = 0) -> dict:
    """The kernel launches of one step(i): every count set to 0 just before
    it, read just after."""
    fa.reset_launch_counts()
    tq.linear_q.launches = 0
    ln_matmul.launches = ln_matmul.linear_launches = 0
    step(i).tolist()
    return {"K1": fa.attention_bshd.fwd_launches,
            "K2": fa.attention_bshd.bwd_launches,
            "K5": tq.linear_q.launches, "K6": ln_matmul.launches,
            "K6 linear": ln_matmul.linear_launches}


def expected_launches(cfg, clip_cfg) -> dict:
    """The launches of one image-LoRA step of a ViT on the default route:
    K1 in each prefix layer, in the window at every update step and once
    more for the clean view; K2 in the window at every update step; K5 in
    the 6 linears of each int8 layer; K6, with `linear`'s epilogue, in q, k,
    v and fc1 of each full-precision prefix layer."""
    lo, hi = resolve_layer_range(cfg, clip_cfg)
    window, steps = hi - lo + 1, effective_update_steps(cfg)
    int8 = (tq.quant_prefix_len(cfg, clip_cfg) if cfg.prefix_quant == "int8"
            else 0)
    return {"K1": lo + window * (steps + 1), "K2": window * steps,
            "K5": 6 * int8, "K6": 4 * (lo - int8),
            "K6 linear": 4 * (lo - int8)}


def check_launches(stage: str, got: dict, cfg, clip_cfg, device) -> None:
    """Fail unless a card run launched what the default route launches.
    The CPU runs the plain versions, and another TTL_FUSED_ATTENTION route
    other kernels: neither is checked."""
    want = expected_launches(cfg, clip_cfg)
    if device.type == "cuda" and fa.fused_mode() == "bshd" and got != want:
        raise RuntimeError(f"{stage}: kernel launches a step {got}, expected "
                           f"{want}")


def bench_device() -> torch.device:
    """The CPU where TTL_BENCH_PLATFORM=cpu asks for it, else this rank's
    card (cuda:LOCAL_RANK), made the current device; no card raises."""
    platform = os.environ.get("TTL_BENCH_PLATFORM", "cuda")
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"TTL_BENCH_PLATFORM={platform!r}: expected "
                         "'cuda' (the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; nothing was "
                           "measured (TTL_BENCH_PLATFORM=cpu runs on the "
                           "CPU)")
    device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    torch.cuda.set_device(device)
    return device


def device_info(device, ranks: int) -> dict:
    """The card's name and power limit (nvidia-smi's `name,power.limit`
    line of its index), and the number of ranks."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None,
                "ranks": ranks}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    smi = lines[min(device.index or 0, len(lines) - 1)]
    return {"platform": "cuda", "name": torch.cuda.get_device_name(device),
            "power_limit": smi.split(",")[-1].strip(), "ranks": ranks}


def agree(flag: bool, world: int) -> bool:
    """True when `flag` holds on every rank (all ranks must take a stage
    with collectives together)."""
    if world == 1:
        return flag
    t = torch.tensor([int(flag)])
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return bool(t.item())


def main() -> int:
    t_start = time.time()
    budget = float(os.environ.get("TTL_BENCH_BUDGET_S", "780"))
    # slack past the budget before the watchdog prints (tests raise it so a
    # slow host cannot race a tight stage-gating budget)
    grace = float(os.environ.get("TTL_BENCH_WATCHDOG_GRACE_S", "60"))
    out: dict = {}  # filled stage by stage; the watchdog prints it as it is

    def remaining() -> float:
        return budget - (time.time() - t_start)

    def watchdog():
        while not _PRINTED.is_set() and remaining() >= -grace:
            time.sleep(1)
        if _PRINTED.is_set():
            return
        if "value" not in out:
            print(f"bench_torch: nothing was measured within the budget "
                  f"({budget:.0f} s + {grace:.0f} s)", file=sys.stderr,
                  flush=True)
            os._exit(1)
        out["watchdog_timeout"] = True
        for _ in range(5):  # the main thread may change `out` mid-dump
            try:
                emit_once(out)
                break
            except Exception:
                time.sleep(0.2)
        os._exit(0)

    threading.Thread(target=watchdog, daemon=True).start()

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        torch.distributed.init_process_group("gloo", init_method="env://")
    try:
        return run_stages(out, remaining)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def run_stages(out: dict, remaining) -> int:
    device = bench_device()
    world, rank = world_and_rank()
    full_f32_products(device)
    out["device"] = device_info(device, world)
    out["launches"] = {}

    # S=10 as bench.py (PERF.md puts S=8 beside it)
    S = int(os.environ.get("TTL_BENCH_S", "10"))
    arch = os.environ.get("TTL_BENCH_ARCH", "ViT-B/16")
    clip_cfg, cfg, params, adapters0, canv, hs, ws = bench_inputs(arch, S,
                                                                 device)
    tables = {}

    def table(n_classes):
        # built lazily: the 1000-class table must not delay the headline
        if n_classes not in tables:
            tables[n_classes] = classifier(params, clip_cfg, n_classes)
        return tables[n_classes]

    skipped = []

    def headline(sps, provisional):
        out.update({
            "metric": f"adapted samples/sec/chip (64-view TTL step, {arch})"
                      "; co-primary: busy_equivalent_sps (device busy "
                      "time)",
            "value": round(sps, 3),
            "unit": "samples/s/chip",
            "sample_batch": S,
        })
        if provisional:
            out["provisional"] = True
        else:
            out.pop("provisional", None)

    def staged(name, value_key, cfg_s, params_s, text_cls_s, canv_s, hs_s,
               ws_s, *, windows, mesh=None, provisional_cb=None):
        """One stage: the launches of its first step (checked on the card),
        the best-window wall rate, then a short busy trace."""
        step_s, S_s = make_step(clip_cfg, cfg_s, params_s, text_cls_s,
                                adapters0, canv_s, hs_s, ws_s, mesh=mesh)
        out["launches"][name] = step_launches(step_s)
        check_launches(name, out["launches"][name], cfg_s, clip_cfg, device)
        wall = measure(clip_cfg, cfg_s, params_s, text_cls_s, adapters0,
                       canv_s, hs_s, ws_s, windows=windows, step=step_s,
                       provisional_cb=provisional_cb)
        out[value_key] = round(wall, 3)
        return step_s, S_s, wall

    def busy_stage(name, step_s, S_s, mesh=None):
        if agree(remaining() > 45, 1 if mesh is None else mesh.world):
            b = busy_ms_for(step_s, device, mesh=mesh)
            if b:
                out[f"busy_{name}_sps"] = round(S_s / (b / 1000.0), 3)
        else:
            skipped.append(f"{name}_busy_trace")

    if rank == 0:
        # the headline: a provisional figure lands in `out` after the first
        # steps, then the windows' figure replaces it
        step_p, _, sps = staged(
            "headline", "value", cfg, params, table(200), canv, hs, ws,
            windows=5, provisional_cb=lambda v: headline(v, True))
        headline(sps, False)

        # the busy-equivalent co-primary, right after the headline
        busy_ms = None
        if remaining() > 60:
            busy_ms = busy_ms_for(step_p, device)
        else:
            skipped.append("busy_trace")
        if busy_ms:
            out["device_busy_ms_per_step"] = round(busy_ms, 3)
            out["busy_equivalent_sps"] = round(S / (busy_ms / 1000.0), 3)

        if remaining() > 150:
            busy_stage("1000_classes", *staged(
                "1000_classes", "value_1000_classes", cfg, params,
                table(1000), canv, hs, ws, windows=5)[:2])
        else:
            skipped.append("1000_classes")

    # several processes: the same step sharded over the ranks, S samples
    # on each; every rank takes this stage or none does
    if world > 1 and agree(remaining() > 180, world):
        mesh = make_mesh((world,), device)
        St = S * world
        step_a, _, aggregate = staged(
            "aggregate", "aggregate_sps", cfg.replace(sample_batch=St),
            params, table(200), np.tile(canv, (world, 1, 1, 1)),
            np.full((St,), 375, np.int32), np.full((St,), 500, np.int32),
            windows=3, mesh=mesh)
        busy_stage("aggregate", step_a, St, mesh)
        out["per_chip_sps"] = round(aggregate / world, 3)
        out["device_count"] = world
    elif world > 1:
        skipped.append("aggregate")
    if rank != 0:
        return 0

    # the int8 frozen prefix (--prefix_quant int8): an auxiliary figure
    if remaining() > 150:
        qcfg = cfg.replace(prefix_quant="int8")
        qparams = tq.attach_prefix_quant(params,
                                         tq.quant_prefix_len(qcfg, clip_cfg))
        busy_stage("int8_prefix", *staged(
            "int8_prefix", "value_int8_prefix", qcfg, qparams,
            table(200), canv, hs, ws, windows=3)[:2])
    else:
        skipped.append("int8_prefix")

    if skipped:
        out["skipped_stages"] = skipped
    emit_once(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
