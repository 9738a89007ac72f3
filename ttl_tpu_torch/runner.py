"""End-to-end evaluation on one device.

Counterpart of `load_model`, `make_adapters0`, `evaluate_dataset` and `run`
in `ttl_tpu/runner.py`, for the LoRA modes (`--lora_encoder image|text`,
with the DeYO objective or, `deyo_selection=False`, the TPT one), prompt
tuning (`--lora_encoder prompt`), CoCoOp (`--cocoop`) and zero-shot
(`--tta_steps 0`), with the single-template or the ensemble (`--ensemble`)
classifier, an optional int8 frozen prefix (`--prefix_quant int8`), PLPD's
filter (`--filter_plpd 1`), AugMix views (`--aug_list`) and an optional
CoOp/CoCoOp prompt checkpoint (`--load`), on the ViT towers and, in every
mode but image-LoRA, on the ResNet towers; with the CLIP weights of
`--checkpoint_path` or random ones. Per dataset it builds
the text side once (the frozen classifier, the class-prompt token table,
the prompt learner or the CoCoOp state), streams samples through
`SampleLoader`, and runs one fused step per batch of `sample_batch` samples:
views rendered on the device, the episodic adaptation and the adapted
clean-view logits (or the center view's zero-shot logits), and top-1/top-5
counts on the device. The `bongard` set runs its own episodic protocol
(`adapt/bongard.py`).

The loader's prefetch thread makes each batch's random view draws and, for
a CUDA device, copies the batch to the device from pinned memory on a
side stream, so the upload overlaps the previous step's compute; the step
waits on that copy's event before it reads the batch. Two A/B switches, read
as the reference reads them: `TTL_UPLOAD_OVERLAP=0` makes the draws and the
upload in the main thread, on the current stream, just before each
dispatch; `TTL_CANVAS_BUCKETS=0` keeps every batch of an auto-canvas run
(`--canvas 0`) at the full canvas instead of the smallest ladder size that
fits it (`data/views.py`). Neither changes a result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .adapt.bongard import evaluate_bongard
from .adapt.cocoop import init_cocoop
from .adapt.ttl import (check_supported, compute_dtype, draw_plpd_perms,
                        make_fused_cocoop_fn, make_fused_tpt_fn,
                        make_fused_ttl_fn, make_fused_zeroshot_fn,
                        plpd_counterfactual)
from .config import TTLConfig, resolve_layer_range
from .data.classnames import resolve_classnames
from .data.registry import build_dataset, dataset_exists, expected_subdir
from .data.views import DEFAULT_CANVAS, SampleLoader
from .models.clip import (VisionConfig, init_clip_params, l2_normalize,
                          lora_compute_mode, ln_stats_mode,
                          text_features_from_embeddings)
from .models.convert import load_checkpoint, params_from_numpy
from .models.prompts import (build_ensemble_classifier, build_text_classifier,
                             init_prompt_learner, prompt_tokens)
from .models.zoo import get_arch
from .ops.image import draw_batch
from .ops.attention import fused_mode, scores_mode
from .ops.lora import adapter_param_count, init_adapters
from .ops.quant import attach_prefix_quant, quant_prefix_len
from .parallel.eval import topk_counts
from .utils.checkpoint import (apply_cocoop_ckpt, apply_prompt_ckpt,
                               load_prompt_state_dict)
from .utils.meters import AverageMeter, ProgressMeter, Summary


def load_model(cfg: TTLConfig, device):
    """(clip_cfg, params): the CLIP weights of `--checkpoint_path` (HF or
    OpenAI .pt/.bin, .safetensors, or a .npz cache of `save_pytree`), read
    with the arch's config, leaves with two or more axes in param_dtype and
    the rest f32, as the JAX runner loads them; without a checkpoint, random
    weights drawn from cfg.seed. With `--prefix_quant int8` the frozen
    vision layers get an int8 copy, and the fp layer stack is dropped where
    the whole tower is quantised."""
    check_supported(cfg)
    if cfg.prefix_quant not in ("none", "int8"):
        raise ValueError(f"prefix_quant={cfg.prefix_quant!r}: expected "
                         "'none' or 'int8'")
    clip_cfg = get_arch(cfg.arch)
    pdtype = (torch.bfloat16 if cfg.param_dtype == "bfloat16"
              else torch.float32)
    if cfg.checkpoint_path:
        tree, clip_cfg = load_checkpoint(cfg.checkpoint_path, clip_cfg)
        params = params_from_numpy(tree, device, pdtype)
    else:
        print("WARNING: no --checkpoint_path; using random-init CLIP weights "
              "(accuracy will be chance level)", flush=True)
        params = init_clip_params(clip_cfg, torch.Generator().manual_seed(
            cfg.seed), device=device, param_dtype=pdtype)
    if cfg.prefix_quant == "int8":
        params = attach_prefix_quant(params, quant_prefix_len(cfg, clip_cfg),
                                     drop_fp=True)
    return clip_cfg, params


def make_adapters0(cfg: TTLConfig, clip_cfg, device) -> Optional[dict]:
    """Fresh adapters for the window of the adapted tower: the vision
    tower's width with `--lora_encoder image`, else the text tower's. None
    for `--lora_encoder image` on a ResNet tower, which has no q/v to adapt
    (zero-shot and CoCoOp run there; `evaluate_dataset` refuses image-LoRA
    adaptation)."""
    image = cfg.lora_encoder == "image"
    if image and not isinstance(clip_cfg.vision, VisionConfig):
        return None
    lo, hi = resolve_layer_range(cfg, clip_cfg)
    tower = clip_cfg.vision if image else clip_cfg.text
    return init_adapters(torch.Generator().manual_seed(cfg.seed),
                         hi - lo + 1, tower.hidden, cfg.rank,
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


def sample_draws(cfg: TTLConfig, indices) -> dict:
    """The host draws of the samples at dataset `indices`, stacked: the
    random views' (with AugMix's when `--aug_list` is set) and, where the
    step runs PLPD's counterfactual, `plpd_perm`. Zero-shot draws nothing;
    CoCoOp renders its views whatever `tta_steps` is."""
    if not (cfg.tta_steps > 0 or cfg.cocoop):
        return {}
    aug = (len(cfg.aug_ops), cfg.aug_severity) if cfg.aug_ops else ()
    draws = draw_batch(cfg.seed, indices, cfg.batch_size, *aug)
    if plpd_counterfactual(cfg):
        perms = [draw_plpd_perms(cfg, int(i)) for i in indices]
        if perms[0] is not None:
            draws["plpd_perm"] = torch.stack(perms)
    return draws


def full_f32_products(device) -> None:
    """f32 products in full f32 on the card, as on the CPU: TF32 off for
    matmuls and convolutions. Every entry point calls it before its first
    product on `device`."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _switched_on(name: str) -> bool:
    """An A/B switch of the reference's runner: on unless set to '0'."""
    return os.environ.get(name, "1") != "0"


def _make_upload(cfg: TTLConfig, device, batch_size: int,
                 overlap: bool = True):
    """SampleBatch -> DeviceBatch. With `overlap` it is the loader's
    transform, run in the prefetch thread, and copies on a side stream;
    without, the caller runs it just before the dispatch and it copies on
    the current stream."""
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card and overlap else None

    def upload(b) -> DeviceBatch:
        host = DeviceBatch(
            torch.from_numpy(b.canvases), torch.from_numpy(b.heights),
            torch.from_numpy(b.widths), sample_draws(cfg, b.indices),
            torch.from_numpy(b.labels.astype(np.int64)),
            torch.from_numpy(np.arange(batch_size) < batch_size - b.pad),
            None)
        if not on_card:
            return host
        stream = copy_stream or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            def put(t):
                return t.pin_memory().to(device, non_blocking=True)
            moved = DeviceBatch(
                put(host.canvases), put(host.hs), put(host.ws),
                {k: put(t) for k, t in host.draws.items()},
                put(host.labels), put(host.valid),
                torch.cuda.Event() if copy_stream else None)
            if copy_stream:
                moved.ready.record(copy_stream)
        return moved

    return upload


def on_current_stream(b: DeviceBatch, device) -> DeviceBatch:
    """Have the current stream wait for a batch uploaded on the side stream,
    and keep its tensors' memory until the current stream has used them."""
    if b.ready is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(b.ready)
        for t in b.tensors():
            t.record_stream(stream)
    return b


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


def prompt_learner(set_id: str, cfg: TTLConfig, params, prompt_ckpt=None):
    """The prompt learner of a set's classes, on the parameters' device,
    from the f32 token embedding table; a CoOp checkpoint's ctx on top."""
    pl_state = init_prompt_learner(params["text"]["token_embed"].float(),
                                   resolve_classnames(set_id), cfg.ctx_init)
    return apply_prompt_ckpt(pl_state, prompt_ckpt) if prompt_ckpt \
        else pl_state


def cocoop_state(set_id: str, cfg: TTLConfig, clip_cfg, params,
                 prompt_ckpt=None):
    """The CoCoOp state of a set's classes, on the parameters' device: the
    meta-net drawn from cfg.seed, a CoCoOp checkpoint's ctx and meta-net on
    top."""
    state = init_cocoop(params["text"]["token_embed"].float(),
                        resolve_classnames(set_id),
                        clip_cfg.vision.proj_dim,
                        torch.Generator().manual_seed(cfg.seed), cfg.ctx_init)
    return apply_cocoop_ckpt(state, prompt_ckpt) if prompt_ckpt else state


@torch.no_grad()
def prompt_classifier(pl_state, cfg: TTLConfig, clip_cfg,
                      params) -> torch.Tensor:
    """Zero-shot in prompt mode: the [C, P] classifier of the prompt
    learner's own, unadapted, ctx prompts."""
    return l2_normalize(text_features_from_embeddings(
        params["text"], pl_state.assemble(pl_state.ctx_init),
        pl_state.tokenized, clip_cfg.text, compute_dtype=compute_dtype(cfg)))


def evaluate_dataset(set_id: str, cfg: TTLConfig, clip_cfg, params,
                     adapters0, *, device, dataset=None,
                     max_samples: Optional[int] = None,
                     prompt_ckpt: Optional[dict] = None) -> List[float]:
    """One dataset: returns [top1, top5] percentages. `prompt_ckpt` is the
    state dict of a `--load` checkpoint, for the modes that read it."""
    if cfg.ensemble and (cfg.cocoop or cfg.lora_encoder != "image"):
        raise ValueError(
            "--ensemble replaces the frozen single-template text classifier "
            "and only applies when that classifier is consumed "
            "(lora_encoder='image', no --cocoop); the requested mode "
            f"(lora_encoder={cfg.lora_encoder!r}, cocoop={cfg.cocoop}) "
            "builds its prompts elsewhere and would silently ignore the "
            "ensemble table")
    if cfg.tta_steps > 0 and cfg.lora_encoder == "image" \
            and not cfg.cocoop \
            and not isinstance(clip_cfg.vision, VisionConfig):
        raise ValueError(
            f"arch {cfg.arch!r} has a ResNet vision tower; image-encoder "
            "LoRA adaptation requires a ViT backbone (as in the reference). "
            "Use --lora_encoder prompt|text or --tta_steps 0.")
    device = torch.device(device)
    if dataset is None:
        dataset = build_dataset(set_id, cfg)
    canvas = cfg.canvas if cfg.canvas > 0 else \
        (getattr(dataset, "max_image_dim", None) or DEFAULT_CANVAS)
    overlap = _switched_on("TTL_UPLOAD_OVERLAP")
    upload = _make_upload(cfg, device, cfg.sample_batch, overlap)
    loader = SampleLoader(
        dataset, batch_size=cfg.sample_batch, shuffle=True, seed=cfg.seed,
        canvas=canvas,
        bucket_canvas=cfg.canvas == 0 and _switched_on("TTL_CANVAS_BUCKETS"),
        max_samples=max_samples, workers=cfg.workers,
        transform=upload if overlap else None)
    if cfg.cocoop:
        # whatever tta_steps is: the reference's final inference ignores the
        # adapted ctx, so `logits` is the conditioned, unadapted prediction
        co_state = cocoop_state(set_id, cfg, clip_cfg, params, prompt_ckpt)
        cocoop = make_fused_cocoop_fn(clip_cfg, cfg)

        def step_fn(b: DeviceBatch) -> torch.Tensor:
            return cocoop(params, co_state, b.canvases, b.hs, b.ws,
                          b.draws).logits
    elif cfg.lora_encoder == "prompt" and cfg.tta_steps > 0:
        pl_state = prompt_learner(set_id, cfg, params, prompt_ckpt)
        tune = make_fused_tpt_fn(clip_cfg, cfg)

        def step_fn(b: DeviceBatch) -> torch.Tensor:
            return tune(params, pl_state, b.canvases, b.hs, b.ws,
                        b.draws)[0].logits
    elif cfg.tta_steps > 0:
        # text mode re-encodes the class prompts at every step: it takes
        # their token table, and no frozen classifier
        if cfg.lora_encoder == "text":
            text_cls = None
            toks = prompt_tokens(resolve_classnames(set_id),
                                 cfg.ctx_init.replace("_", " "))
        else:
            text_cls = text_classifier(set_id, cfg, clip_cfg, params,
                                       device=device)
            toks = None
        adapt = make_fused_ttl_fn(clip_cfg, cfg, tokens=toks)

        def step_fn(b: DeviceBatch) -> torch.Tensor:
            return adapt(params, text_cls, adapters0, b.canvases, b.hs, b.ws,
                         b.draws).logits
    else:
        # zero-shot on the deterministic center view; in prompt mode with
        # the prompt learner's own unadapted ctx prompts
        if cfg.lora_encoder == "prompt":
            text_cls = prompt_classifier(
                prompt_learner(set_id, cfg, params, prompt_ckpt), cfg,
                clip_cfg, params)
        else:
            text_cls = text_classifier(set_id, cfg, clip_cfg, params,
                                       device=device)
        zeroshot = make_fused_zeroshot_fn(clip_cfg, cfg)

        def step_fn(b: DeviceBatch) -> torch.Tensor:
            return zeroshot(params, text_cls, b.canvases, b.hs, b.ws)

    batch_time = AverageMeter("Time", ":6.3f", Summary.NONE)
    top1 = AverageMeter("Acc@1", ":6.2f", Summary.AVERAGE)
    top5 = AverageMeter("Acc@5", ":6.2f", Summary.AVERAGE)
    progress = ProgressMeter(len(loader), [batch_time, top1, top5],
                             prefix="Test: ")

    n_classes = len(resolve_classnames(set_id))

    @contextlib.contextmanager
    def oom_hint():
        """A device out-of-memory error names the one switch that helps.
        It can come at the dispatch or, the step running asynchronously,
        when `drain` reads the counts."""
        try:
            yield
        except RuntimeError as e:
            if not (isinstance(e, torch.cuda.OutOfMemoryError)
                    or "out of memory" in str(e).lower()):
                raise
            raise RuntimeError(
                f"device out of memory on the {set_id} step at "
                f"sample_batch={cfg.sample_batch} with {n_classes} classes; "
                "reduce --sample_batch (per-sample results do not depend on "
                "it)") from e

    def dispatch(b) -> torch.Tensor:
        b = on_current_stream(b if overlap else upload(b), device)
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
    with oom_hint():
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
    full_f32_products(device)
    # an unknown TTL_FUSED_ATTENTION, TTL_LN_STATS, TTL_LORA_COMPUTE or
    # TTL_ATTN_SCORES raises before any work
    for read_switch in (fused_mode, ln_stats_mode, lora_compute_mode,
                        scores_mode):
        read_switch()
    clip_cfg, params = load_model(cfg, device)
    adapters0 = (None if cfg.lora_encoder == "prompt"
                 else make_adapters0(cfg, clip_cfg, device))
    extra = (f" ({adapter_param_count(adapters0):,} LoRA params/sample)"
             if adapters0 is not None else "")
    print(f"=> Model created: visual backbone {cfg.arch}{extra}", flush=True)
    prompt_ckpt = None
    if cfg.load and (cfg.cocoop or cfg.lora_encoder == "prompt"):
        prompt_ckpt = load_prompt_state_dict(cfg.load)
    elif cfg.load:
        print(f"WARNING: --load {cfg.load} is a CoOp/CoCoOp prompt "
              "checkpoint and has no effect in the LoRA modes; ignoring it, "
              "as the reference does", flush=True)

    results: Dict[str, List[float]] = {}
    for set_id in cfg.test_sets.split("/"):
        print(f"evaluating: {set_id}", flush=True)
        ds = datasets.get(set_id) if datasets else None
        if ds is None and set_id != "bongard":
            sub = expected_subdir(set_id)
            if sub is not None and not dataset_exists(set_id, cfg.data):
                raise FileNotFoundError(
                    f"dataset {set_id!r} not found under {cfg.data!r} "
                    f"(expected directory {sub!r}); pass the dataset root "
                    "as the positional DATA argument or --data")
        if set_id == "bongard":
            # the episodic few-shot protocol (a support-prototype
            # classifier); the 2-way task has no meaningful top-5
            acc = evaluate_bongard(
                cfg, ds if ds is not None else build_dataset(set_id, cfg),
                clip_cfg, params, adapters0, device=device,
                max_episodes=max_samples)
            results[set_id] = [acc, 100.0]
        else:
            results[set_id] = evaluate_dataset(
                set_id, cfg, clip_cfg, params, adapters0, device=device,
                dataset=ds, max_samples=max_samples, prompt_ckpt=prompt_ckpt)
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
