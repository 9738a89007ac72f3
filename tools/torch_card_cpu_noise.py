"""How far two correct runs of an adapted path of `ttl_tpu_torch` lie apart.

`chip_smoke.py` holds one sample on the card against the same sample
through the plain versions on the CPU. On a path whose logits come after an
AdamW step, the logits are mostly the path's own noise: AdamW's first step
is lr * sign(g) for every element of the trainable state, so an element
whose gradient is smaller than the bf16 noise moves the other way in any two
runs that sum in another order. The smoke therefore bounds the gradient that
step hands AdamW (`chip_smoke.first_update_gradient`), relative to its
largest element. This script measures both floors. For the images made from
each seed it runs the sample on the CPU (plain versions), on the card
through the path's kernel route, and on the card through the einsum route
(no hand-written attention kernel), and prints for each pair the largest
difference of the adapted logits and of the gradient over its largest
element (and, on the DeYO paths, how many views the first loss kept on one
side only); then, per path, the largest and the median over the seeds.

With `--views`, it measures instead the AugMix views
(`chip_smoke.augmix_view_diff` over DEFAULT_AUG_LIST): per seed the share
of values that differ by more than 1/255 between card and CPU, the largest
difference among the others, and the largest of each over the seeds.

With `--model_axis`, it measures instead the model axis against one
process, both on the card: `chip_smoke.phase_model_axis` over the images
made from each seed, with no bound, and per seed and over the seeds the
largest difference of rank 0's logits (each sample) and first-update
gradient (each batch) from the one process's, relative to the largest
element: the source of chip_smoke.MODEL_AXIS_BOUND_REL.

Run from the root of the repository, on a machine with the card:

    python3 tools/torch_card_cpu_noise.py [--paths main prompt ...]
        [--seeds 1 8] [--views | --model_axis]
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# path: (flags, TTL_FUSED_ATTENTION of its kernel route (None: unset), its
# key in chip_smoke.GRAD_BOUND_REL)
PATHS = {"main": ((), None, "main path"),
         "int8": (("--prefix_quant", "int8"), None, "int8 main path"),
         "text": (("--lora_encoder", "text"), "per_head", "text-LoRA"),
         "prompt": (("--lora_encoder", "prompt"), "heads", "prompt tuning"),
         "tpt_lora": (("--deyo_selection", "False"), None, "TPT on LoRA"),
         "cocoop": (("--cocoop",), None, "CoCoOp"),
         "plpd": (cs.PLPD_FLAGS, None, "PLPD"),
         "rn50_prompt": (cs.RN50_PROMPT_FLAGS, "heads",
                         "RN50 prompt tuning")}


def views(seeds) -> None:
    """AugMix views, card against CPU, per image seed."""
    from ttl_tpu_torch.ops.augmix import DEFAULT_AUG_LIST
    cfg = cs.config("--aug_list", ",".join(DEFAULT_AUG_LIST))
    worst = {}
    for seed in range(seeds[0], seeds[1] + 1):
        d = cs.augmix_view_diff(cfg, image_seed=seed)
        cs.log(f"AugMix views, seed {seed}: {100 * d['step_share']:.5f} % of "
               f"values differ by more than 1/255, "
               f"{100 * d['above_1e-4']:.5f} % by more than 1e-4; largest "
               f"difference elsewhere {d['elsewhere']:.4e}")
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in d.items()}
    cs.log(f"AugMix views over seeds {seeds[0]}-{seeds[1]}: largest share "
           f"above 1/255 {worst['step_share']:.4e} (bound in chip_smoke.py "
           f"{cs.AUGMIX_STEP_SHARE:.4e}), above 1e-4 "
           f"{worst['above_1e-4']:.4e} (bound {cs.AUGMIX_DIFF_SHARE:.4e}); "
           f"largest difference elsewhere {worst['elsewhere']:.4e}")


def model_axis(seeds) -> None:
    """Phase 34, rank 0 against one process, per image seed."""
    from ttl_tpu_torch.ops import _build
    build_dir = _build.build().parent
    worst = {"logits": 0.0, "gradient": 0.0}
    for seed in range(seeds[0], seeds[1] + 1):
        errors = cs.phase_model_axis(build_dir, seed=seed, bound={})["errors"]
        cs.log(f"model axis, seed {seed}: logits {errors['logits']:.4e}, "
               f"first-update gradient {errors['gradient']:.4e} of the "
               f"largest element")
        worst = {k: max(v, errors[k]) for k, v in worst.items()}
    cs.log(f"model axis over seeds {seeds[0]}-{seeds[1]}: largest logits "
           f"{worst['logits']:.4e}, gradient {worst['gradient']:.4e} "
           f"(bounds in chip_smoke.py {cs.MODEL_AXIS_BOUND_REL})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", choices=sorted(PATHS), nargs="+",
                    default=list(PATHS))
    ap.add_argument("--seeds", type=int, nargs=2, default=(1, 8),
                    metavar=("FIRST", "LAST"))
    ap.add_argument("--views", action="store_true",
                    help="measure the AugMix views instead of the paths")
    ap.add_argument("--model_axis", action="store_true",
                    help="measure the model axis against one process "
                         "instead of the paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ttl_tpu_torch.ops import attention as fa
    cs.log(f"{torch.cuda.get_device_name(0)}")
    if args.views:
        views(args.seeds)
        return 0
    if args.model_axis:
        model_axis(args.seeds)
        return 0
    for path in args.paths:
        flags, route, bound_key = PATHS[path]
        cfg = cs.config(*flags)
        spread = {"kernel": [], "einsum": []}
        for seed in range(args.seeds[0], args.seeds[1] + 1):
            runs = {}
            for name, mode, device in (("cpu", route, "cpu"),
                                       ("kernel", route, "cuda"),
                                       ("einsum", "off", "cuda")):
                with cs.attention_route(fa, mode):
                    runs[name] = cs.sample_step(cfg, image_seed=seed)(
                        torch.device(device))

            def logits(name):   # the adapted logits (CoCoOp: second row)
                return runs[name].logits.reshape(
                    -1, runs[name].logits.shape[-1])[-1]

            def diffs(a):
                grad = cs.relative_gradient_error(runs[a], runs["cpu"])
                spread[a].append(grad)
                return (f"logits {(logits(a) - logits('cpu')).abs().max():.4f}"
                        f", gradient {grad:.4e}")

            top2 = logits("cpu").topk(2).values
            if runs["cpu"].keep is not None:
                cs.log(f"{path}, seed {seed}: views kept by the first DeYO "
                       f"loss on one side only, kernel "
                       + ", einsum ".join(
                           str(int((runs[a].keep != runs["cpu"].keep).sum()))
                           for a in ("kernel", "einsum"))
                       + f" (of {runs['cpu'].keep.numel()}; CPU kept "
                       f"{int(runs['cpu'].keep.sum())})")
            cs.log(f"{path}, seed {seed}: kernel vs CPU {diffs('kernel')}; "
                   f"einsum on the card vs CPU {diffs('einsum')}; top-1 "
                   f"{int(logits('kernel').argmax())} / "
                   f"{int(logits('einsum').argmax())} / "
                   f"{int(logits('cpu').argmax())}, CPU margin to the second "
                   f"{(top2[0] - top2[1]).item():.4f}")
        cs.log(f"{path} ({route or 'bshd'} route), gradient vs CPU over "
               f"seeds {args.seeds[0]}-{args.seeds[1]}: "
               + "; ".join(f"{name} largest {max(v):.4e}, median "
                           f"{statistics.median(v):.4e}"
                           for name, v in spread.items())
               + f" (bound in chip_smoke.py: "
               f"{cs.GRAD_BOUND_REL[bound_key]:.4e} of the largest element)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
