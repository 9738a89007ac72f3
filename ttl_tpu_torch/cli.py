"""`python -m ttl_tpu_torch DATA --test_sets A`: the reference CLI on CUDA.

The port's own copy of the parser in `ttl_tpu/cli.py`: every flag parses
with the same name, type and default as for `python -m ttl_tpu`. The run
goes to `cuda:{--gpu}`; without CUDA the CLI raises and never carries on on
the CPU. `--profile` and `--init_distributed`, and the flags the port does
not cover yet, raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import argparse

import torch

from .config import TTLConfig


def list_of_ints(arg: str):
    return tuple(int(x) for x in arg.split(","))


def build_parser() -> argparse.ArgumentParser:
    d = TTLConfig()
    p = argparse.ArgumentParser(description="Test-time Prompt Tuning (CUDA)")
    p.add_argument("data_pos", metavar="DIR", nargs="?", default=None,
                   help="path to dataset root")
    p.add_argument("--data", dest="data_flag", default=None,
                   help="dataset root (flag form, as scripts/test_ttl.sh "
                        "passes it)")
    p.add_argument("--test_sets", type=str, default=d.test_sets,
                   help="test dataset (multiple datasets split by slash)")
    p.add_argument("--dataset_mode", type=str, default=d.dataset_mode)
    p.add_argument("-a", "--arch", metavar="ARCH", default=d.arch,
                   help="ViT-B/16, ViT-B/32, ViT-L/14, ViT-L/14@336px, or a "
                        "ResNet tower (RN50, RN101, RN50x4, RN50x16, "
                        "RN50x64: every mode but image-LoRA adaptation)")
    p.add_argument("--resolution", default=d.resolution, type=int)
    p.add_argument("-j", "--workers", default=d.workers, type=int)
    p.add_argument("-b", "--batch-size", dest="batch_size",
                   default=d.batch_size, type=int)
    p.add_argument("--lr", "--learning-rate", dest="lr", default=d.lr,
                   type=float)
    p.add_argument("-p", "--print_freq", default=d.print_freq, type=int)
    p.add_argument("--gpu", default=d.gpu, type=int,
                   help="CUDA device index of the run")
    p.add_argument("--tpt", action="store_true", default=d.tpt)
    p.add_argument("--selection_p", default=d.selection_p, type=float)
    p.add_argument("--tta_steps", default=d.tta_steps, type=int)
    p.add_argument("--n_ctx", default=d.n_ctx, type=int)
    p.add_argument("--ctx_init", default=d.ctx_init, type=str)
    p.add_argument("--cocoop", action="store_true", default=d.cocoop)
    p.add_argument("--ensemble", action="store_true", default=d.ensemble,
                   help="80-template ensemble text classifier (the "
                        "README's 'Ensemble (80 prompts)' baseline)")
    p.add_argument("--load", default=d.load, type=str)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--images_per_class", default=d.images_per_class, type=int)
    p.add_argument("--layer_range", type=list_of_ints, default=d.layer_range,
                   help="inclusive LoRA window 'lo,hi'; default: the last 3 "
                        "layers of the adapted tower ((9,11) on 12-layer "
                        "towers = the reference default; (21,23) on "
                        "ViT-L/14's 24-layer vision tower)")
    p.add_argument("--init_method", default=d.init_method,
                   type=lambda s: None if s in ("None", "none") else s,
                   choices=["xavier", "gaussian", "kaiming", "pretrained",
                            None],
                   help="LoRA A init; 'None' selects the reference's "
                        "None branch (== xavier, custom_clip.py:184)")
    p.add_argument("--lora_encoder", default=d.lora_encoder,
                   choices=["text", "image", "prompt"])
    p.add_argument("--rank", default=d.rank, type=int)

    # DeYO flags (ttl.py:408-424)
    p.add_argument("--deyo_selection", default=d.deyo_selection)
    p.add_argument("--aug_type", default=d.aug_type, type=str)
    p.add_argument("--occlusion_size", default=d.occlusion_size, type=int)
    p.add_argument("--patch_len", default=d.patch_len, type=int)
    p.add_argument("--row_start", default=d.row_start, type=int)
    p.add_argument("--column_start", default=d.column_start, type=int)
    p.add_argument("--deyo_margin", default=d.deyo_margin, type=float)
    p.add_argument("--deyo_margin_e0", default=d.deyo_margin_e0, type=float)
    p.add_argument("--plpd_threshold", default=d.plpd_threshold, type=float)
    p.add_argument("--fishers", default=d.fishers, type=int)
    p.add_argument("--filter_ent", default=d.filter_ent, type=int)
    p.add_argument("--filter_plpd", default=d.filter_plpd, type=int)
    p.add_argument("--reweight_ent", default=d.reweight_ent, type=int)
    p.add_argument("--reweight_plpd", default=d.reweight_plpd, type=int)

    # AugMix view chains (reference aug_list, datautils.py:110-138; the
    # reference hardcodes aug_list=[] - this flag exposes the shipped-but-
    # disabled capability)
    p.add_argument("--aug_list", dest="aug_ops", default=d.aug_ops,
                   type=lambda s: tuple(x for x in s.split(",") if x),
                   help="comma-separated AugMix ops (e.g. autocontrast,"
                        "equalize,posterize); empty (default) = crop+flip "
                        "views only, matching the reference")
    p.add_argument("--aug_severity", default=d.aug_severity, type=int)

    # extensions of the reference CLI
    p.add_argument("--sample_batch", default=d.sample_batch, type=int,
                   help="test samples adapted concurrently per step")
    p.add_argument("--canvas", default=d.canvas, type=int,
                   help="host->device canvas edge in pixels; 0 = auto "
                        "(fit datasets that declare their image size, else "
                        "512). Set to the dataset's max image dim to cut "
                        "upload bandwidth; identical results whenever no "
                        "image exceeds it")
    p.add_argument("--pipeline_depth", default=d.pipeline_depth, type=int,
                   help="device steps kept in flight by the eval loop "
                        "(results identical at any depth; raise for small "
                        "fast programs where the per-step round trip "
                        "dominates)")
    p.add_argument("--checkpoint_path", default=d.checkpoint_path, type=str,
                   help="local CLIP checkpoint, read with -a's config: HF "
                        "(.bin/.pt/.safetensors) or OpenAI (.pt, ViT or "
                        "ResNet) layout, or a .npz cache written by "
                        "models.convert.save_pytree of either package; "
                        "without one the weights are random")
    p.add_argument("--compute_dtype", default=d.compute_dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--prefix_quant", default=d.prefix_quant,
                   choices=["none", "int8"],
                   help="int8-quantize the frozen vision layers below the "
                        "LoRA window (whole tower when it is frozen): "
                        "small numeric deviation; default off "
                        "(full-precision parity config)")
    p.add_argument("--param_dtype", default=d.param_dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--max_samples", default=None, type=int,
                   help="cap samples per dataset (smoke runs)")
    p.add_argument("--mesh_shape", type=list_of_ints, default=None,
                   help="device mesh, e.g. 8 (data) or 4,2 (data,model); "
                        "default: all devices on the data axis")
    p.add_argument("--profile", default=None, type=str, metavar="DIR",
                   help="not ported yet: raises NotImplementedError")
    p.add_argument("--results_json", default=None, type=str, metavar="PATH",
                   help="also write the end-of-run summary (per-set "
                        "top1/top5 + the exact config) as JSON to PATH")
    p.add_argument("--init_distributed", action="store_true",
                   help="not ported yet: raises NotImplementedError")
    return p


def config_from_args(args: argparse.Namespace) -> TTLConfig:
    fields = {f for f in TTLConfig.__dataclass_fields__}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["data"] = (getattr(args, "data_flag", None)
                  or getattr(args, "data_pos", None) or TTLConfig().data)
    # argparse bool-ish flags arrive as strings when set on the command line
    if isinstance(kw.get("deyo_selection"), str):
        kw["deyo_selection"] = kw["deyo_selection"].lower() in ("1", "true")
    if kw.get("layer_range") is not None and len(kw["layer_range"]) != 2:
        raise SystemExit("--layer_range expects 'lo,hi' (inclusive), e.g. 9,11")
    return TTLConfig(**kw)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.profile:
        raise NotImplementedError("--profile is not ported yet "
                                  "(ROADMAP Queue 1, item 18)")
    if args.init_distributed:
        raise NotImplementedError("--init_distributed is not ported yet "
                                  "(ROADMAP Queue 1, item 17)")
    if not torch.cuda.is_available():
        raise RuntimeError("ttl_tpu_torch needs a CUDA device; none is "
                           "available")
    from .runner import run
    return run(cfg, device=torch.device(f"cuda:{cfg.gpu}"),
               max_samples=args.max_samples)


if __name__ == "__main__":
    main()
