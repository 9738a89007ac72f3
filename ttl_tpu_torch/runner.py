"""End-to-end evaluation on one device.

Counterpart of `load_model`, `make_adapters0`, `evaluate_dataset` and `run`
in `ttl_tpu/runner.py`, for the image-LoRA mode and zero-shot
(`--tta_steps 0`), with the single-template or the ensemble (`--ensemble`)
classifier and an optional int8 frozen prefix (`--prefix_quant int8`). Per
dataset it builds the frozen text classifier once, streams samples through
the JAX package's `SampleLoader`, and runs one fused step per batch of
`sample_batch` samples: views rendered on the device, the episodic
adaptation and the adapted clean-view logits (or the center view's
zero-shot logits), and top-1/top-5 counts on the device.

The loader's prefetch thread makes each batch's random view draws and, for
a CUDA device, copies the batch to the device from pinned memory on a
side stream, so the upload overlaps the previous step's compute; the step
waits on that copy's event before it reads the batch.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ttl_tpu.config import TTLConfig, resolve_layer_range
from ttl_tpu.data.classnames import resolve_classnames
from ttl_tpu.data.registry import build_dataset
from ttl_tpu.data.views import DEFAULT_CANVAS, SampleLoader
from ttl_tpu.utils.meters import AverageMeter, ProgressMeter, Summary

from .adapt.ttl import (check_supported, compute_dtype, make_fused_ttl_fn,
                        make_fused_zeroshot_fn)
from .models.clip import init_clip_params
from .models.prompts import (build_ensemble_classifier, build_text_classifier,
                             prompt_tokens)
from .models.zoo import get_arch
from .ops.image import draw_batch
from .ops.lora import adapter_param_count, init_adapters
from .ops.quant import attach_prefix_quant, quant_prefix_len
from .parallel.eval import topk_counts


def load_model(cfg: TTLConfig, device):
    """(clip_cfg, params) with random weights drawn from cfg.seed: no CLIP
    checkpoint can be loaded yet (ROADMAP Queue 1, item 14). With
    `--prefix_quant int8` the frozen vision layers get an int8 copy, and the
    fp layer stack is dropped where the whole tower is quantised."""
    check_supported(cfg)
    if cfg.prefix_quant not in ("none", "int8"):
        raise ValueError(f"prefix_quant={cfg.prefix_quant!r}: expected "
                         "'none' or 'int8'")
    clip_cfg = get_arch(cfg.arch)
    pdtype = (torch.bfloat16 if cfg.param_dtype == "bfloat16"
              else torch.float32)
    print("WARNING: no --checkpoint_path; using random-init CLIP weights "
          "(accuracy will be chance level)", flush=True)
    params = init_clip_params(clip_cfg, torch.Generator().manual_seed(
        cfg.seed), device=device, param_dtype=pdtype)
    if cfg.prefix_quant == "int8":
        params = attach_prefix_quant(params, quant_prefix_len(cfg, clip_cfg),
                                     drop_fp=True)
    return clip_cfg, params


def make_adapters0(cfg: TTLConfig, clip_cfg, device) -> dict:
    lo, hi = resolve_layer_range(cfg, clip_cfg)
    return init_adapters(torch.Generator().manual_seed(cfg.seed),
                         hi - lo + 1, clip_cfg.vision.hidden, cfg.rank,
                         cfg.init_method, device=device)


class DeviceBatch(NamedTuple):
    canvases: torch.Tensor
    hs: torch.Tensor
    ws: torch.Tensor
    draws: dict
    labels: torch.Tensor
    valid: torch.Tensor
    ready: Optional[torch.cuda.Event]   # the upload's completion (CUDA)

    def tensors(self):
        return [self.canvases, self.hs, self.ws, self.labels, self.valid,
                *self.draws.values()]


def _make_upload(cfg: TTLConfig, device, batch_size: int):
    """The loader transform: SampleBatch -> DeviceBatch, run in the loader's
    prefetch thread. Zero-shot draws no random views."""
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def upload(b) -> DeviceBatch:
        host = DeviceBatch(
            torch.from_numpy(b.canvases), torch.from_numpy(b.heights),
            torch.from_numpy(b.widths),
            (draw_batch(cfg.seed, b.indices, cfg.batch_size)
             if cfg.tta_steps > 0 else {}),
            torch.from_numpy(b.labels.astype(np.int64)),
            torch.from_numpy(np.arange(batch_size) < batch_size - b.pad),
            None)
        if copy_stream is None:
            return host
        with torch.cuda.stream(copy_stream):
            def put(t):
                return t.pin_memory().to(device, non_blocking=True)
            moved = DeviceBatch(
                put(host.canvases), put(host.hs), put(host.ws),
                {k: put(t) for k, t in host.draws.items()},
                put(host.labels), put(host.valid), torch.cuda.Event())
            moved.ready.record(copy_stream)
        return moved

    return upload


def text_classifier(set_id: str, cfg: TTLConfig, clip_cfg, params, *,
                    device) -> torch.Tensor:
    """The frozen [C, proj_dim] classifier of a set's class prompts: the
    template ensemble with `--ensemble`, else one '<ctx_init> <class>.'
    prompt per class."""
    classnames = resolve_classnames(set_id)
    if cfg.ensemble:
        return build_ensemble_classifier(params["text"], classnames,
                                         clip_cfg.text, device=device,
                                         compute_dtype=compute_dtype(cfg))
    toks = prompt_tokens(classnames, cfg.ctx_init.replace("_", " "))
    return build_text_classifier(params["text"], toks, clip_cfg.text,
                                 device=device,
                                 compute_dtype=compute_dtype(cfg))


def evaluate_dataset(set_id: str, cfg: TTLConfig, clip_cfg, params,
                     adapters0, *, device, dataset=None,
                     max_samples: Optional[int] = None) -> List[float]:
    """One dataset: returns [top1, top5] percentages."""
    if cfg.ensemble and (cfg.cocoop or cfg.lora_encoder != "image"):
        raise ValueError(
            "--ensemble replaces the frozen single-template text classifier "
            "and only applies when that classifier is consumed "
            "(lora_encoder='image', no --cocoop); the requested mode "
            f"(lora_encoder={cfg.lora_encoder!r}, cocoop={cfg.cocoop}) "
            "builds its prompts elsewhere and would silently ignore the "
            "ensemble table")
    device = torch.device(device)
    if dataset is None:
        dataset = build_dataset(set_id, cfg)
    text_cls = text_classifier(set_id, cfg, clip_cfg, params, device=device)
    canvas = cfg.canvas if cfg.canvas > 0 else \
        (getattr(dataset, "max_image_dim", None) or DEFAULT_CANVAS)
    loader = SampleLoader(
        dataset, batch_size=cfg.sample_batch, shuffle=True, seed=cfg.seed,
        canvas=canvas, bucket_canvas=cfg.canvas == 0,
        max_samples=max_samples, workers=cfg.workers,
        transform=_make_upload(cfg, device, cfg.sample_batch))
    if cfg.tta_steps > 0:
        adapt = make_fused_ttl_fn(clip_cfg, cfg)

        def step_fn(b: DeviceBatch) -> torch.Tensor:
            return adapt(params, text_cls, adapters0, b.canvases, b.hs, b.ws,
                         b.draws).logits
    else:
        # zero-shot on the deterministic center view
        zeroshot = make_fused_zeroshot_fn(clip_cfg, cfg)

        def step_fn(b: DeviceBatch) -> torch.Tensor:
            return zeroshot(params, text_cls, b.canvases, b.hs, b.ws)

    batch_time = AverageMeter("Time", ":6.3f", Summary.NONE)
    top1 = AverageMeter("Acc@1", ":6.2f", Summary.AVERAGE)
    top5 = AverageMeter("Acc@5", ":6.2f", Summary.AVERAGE)
    progress = ProgressMeter(len(loader), [batch_time, top1, top5],
                             prefix="Test: ")

    def dispatch(b: DeviceBatch) -> torch.Tensor:
        if b.ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(b.ready)
            for t in b.tensors():
                t.record_stream(stream)
        return topk_counts(step_fn(b), b.labels, b.valid)

    def drain(i, pending):
        c1, c5, n = pending.tolist()
        if n > 0:
            top1.update(100.0 * c1 / n, n)
            top5.update(100.0 * c5 / n, n)
        batch_time.update(time.time() - end)
        if (i + 1) % cfg.print_freq == 0:
            progress.display(i)

    # keep steps queued on the device while the host reads older counts
    depth = max(1, cfg.pipeline_depth)
    in_flight = []
    end = time.time()
    for i, b in enumerate(loader):
        in_flight.append((i, dispatch(b)))
        if len(in_flight) > depth:
            drain(*in_flight.pop(0))
            end = time.time()
    for item in in_flight:
        drain(*item)
        end = time.time()
    progress.display_summary()
    return [top1.avg, top5.avg]


def run(cfg: TTLConfig, *, device, datasets: Optional[Dict] = None,
        max_samples: Optional[int] = None) -> Dict[str, List[float]]:
    """Every set of cfg.test_sets, with the reference's summary table.
    `datasets` optionally maps set_id -> dataset object (tests, smoke runs)."""
    device = torch.device(device)
    check_supported(cfg)
    if "bongard" in cfg.test_sets.split("/"):
        raise NotImplementedError("the bongard set is not ported yet "
                                  "(ROADMAP Queue 1, item 16)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    clip_cfg, params = load_model(cfg, device)
    adapters0 = make_adapters0(cfg, clip_cfg, device)
    print(f"=> Model created: visual backbone {cfg.arch} "
          f"({adapter_param_count(adapters0):,} LoRA params/sample)",
          flush=True)
    if cfg.load:
        print(f"WARNING: --load {cfg.load} is a CoOp/CoCoOp prompt "
              "checkpoint and has no effect in the LoRA modes; ignoring it, "
              "as the reference does", flush=True)

    results: Dict[str, List[float]] = {}
    for set_id in cfg.test_sets.split("/"):
        print(f"evaluating: {set_id}", flush=True)
        ds = datasets.get(set_id) if datasets else None
        if ds is None:
            from ttl_tpu.data.registry import dataset_exists, expected_subdir
            sub = expected_subdir(set_id)
            if sub is not None and not dataset_exists(set_id, cfg.data):
                raise FileNotFoundError(
                    f"dataset {set_id!r} not found under {cfg.data!r} "
                    f"(expected directory {sub!r}); pass the dataset root "
                    "as the positional DATA argument or --data")
        results[set_id] = evaluate_dataset(
            set_id, cfg, clip_cfg, params, adapters0, device=device,
            dataset=ds, max_samples=max_samples)
        print("=> Acc. on testset [{}]: @1 {:.2f}/ @5 {:.2f}".format(
            set_id, results[set_id][0], results[set_id][1]), flush=True)

    print("======== Result Summary ========")
    print("params: nstep\tlr\tbs")
    print(f"params: {cfg.tta_steps}\t{cfg.lr}\t{cfg.batch_size}")
    print("\t\t [set_id] \t\t Top-1 acc. \t\t Top-5 acc.")
    print("\t".join(results.keys()))
    print("\t".join(f"{v[0]:.2f}" for v in results.values()))
    if cfg.results_json:
        payload = {
            "results": {k: {"top1": round(v[0], 4), "top5": round(v[1], 4)}
                        for k, v in results.items()},
            "config": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in dataclasses.asdict(cfg).items()},
        }
        with open(cfg.results_json, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        print(f"results written to {cfg.results_json}", flush=True)
    return results
