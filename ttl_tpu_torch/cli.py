"""`python -m ttl_tpu_torch DATA --test_sets A`: the reference CLI on CUDA.

The port's own copy of the parser in `ttl_tpu/cli.py`: every flag parses
with the same name, type and default as for `python -m ttl_tpu`. The run
goes to `cuda:{--gpu}`; without CUDA the CLI raises and never carries on on
the CPU. `--profile DIR` traces the run with torch.profiler into DIR
(DIR/rank<r> under several processes) and prints rank 0's top device
operations. `--init_distributed` joins the process group that
`python -m torch.distributed.run` describes in the environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), over gloo, and the rank runs on
`cuda:{LOCAL_RANK}`: N cards take N processes. `--mesh_shape d,m` lays
them out as JAX's (data, model) mesh: each model group of m ranks splits
the towers' heads and MLP columns (`parallel/`); without
`--init_distributed` any shape but 1 raises ValueError before the card is
touched.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed

from .adapt.ttl import check_supported
from .config import TTLConfig
from .parallel.mesh import check_mesh_shape, world_and_rank


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
                   help="process mesh, N (data) or N,M (data, model); its "
                        "product is the number of processes (default: all "
                        "on the data axis); a model axis of M splits every "
                        "transformer layer's heads and MLP over M ranks")
    p.add_argument("--profile", default=None, type=str, metavar="DIR",
                   help="trace the run with torch.profiler into DIR and "
                        "print the top device ops")
    p.add_argument("--results_json", default=None, type=str, metavar="PATH",
                   help="also write the end-of-run summary (per-set "
                        "top1/top5 + the exact config) as JSON to PATH")
    p.add_argument("--init_distributed", action="store_true",
                   help="join the torch.distributed group of the "
                        "environment (python -m torch.distributed.run "
                        "--nproc_per_node N): each process runs on "
                        "cuda:LOCAL_RANK and loads its shard of the samples; "
                        "the counts are summed over processes")
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
    if args.init_distributed and cfg.gpu != TTLConfig().gpu:
        raise ValueError("--gpu does not apply with --init_distributed: each "
                         "process runs on cuda:LOCAL_RANK")
    check_supported(cfg)
    if not args.init_distributed:
        check_mesh_shape(cfg.mesh_shape, 1)
    if not torch.cuda.is_available():
        raise RuntimeError("ttl_tpu_torch needs a CUDA device; none is "
                           "available")
    from .runner import run
    device = torch.device(f"cuda:{cfg.gpu}")
    if args.init_distributed:
        torch.distributed.init_process_group("gloo", init_method="env://")
        device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    # the kernels launch on the current device's streams: make it this
    # process's card
    torch.cuda.set_device(device)
    try:
        if not args.profile:
            return run(cfg, device=device, max_samples=args.max_samples)
        from .utils.profiling import op_stats, trace
        world, rank = world_and_rank()
        # each rank traces its own card
        log_dir = args.profile if world == 1 else os.path.join(
            args.profile, f"rank{rank}")
        with trace(log_dir, device):
            results = run(cfg, device=device, max_samples=args.max_samples)
        if rank == 0:
            for row in op_stats(log_dir):
                print(f"{row['fraction']*100:5.1f}%  "
                      f"{row['bound_by'] or '':10}"
                      f"  {str(row['operation'])[:90]}")
        return results
    finally:
        if args.init_distributed:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
