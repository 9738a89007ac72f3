"""How far two correct runs of a text-side path of `ttl_tpu_torch` lie apart.

`chip_smoke.py` holds one sample's logits on the card (K3 or K4) against the
same sample through the plain version on the CPU, within CARD_CPU_BOUND. On
the prompt-tuning path that difference is mostly the path's own: AdamW's
first step is lr * sign(g) for every element of the ctx, so an element whose
gradient is smaller than the bf16 noise moves the other way in any two runs
that sum in another order. This script measures that floor. For the images
made from each seed it runs the sample on the CPU (plain version), on the
card through the kernel route, and on the card through the einsum route (no
hand-written attention kernel), and prints the largest difference of the
logits between each pair.

Run from the root of the repository, on a machine with the card:

    python3 tools/torch_card_cpu_noise.py [--path prompt|text] [--seeds 1 12]
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

PATHS = {"prompt": (("--lora_encoder", "prompt"), "heads"),
         "text": (("--lora_encoder", "text"), "per_head")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="prompt")
    ap.add_argument("--seeds", type=int, nargs=2, default=(1, 12),
                    metavar=("FIRST", "LAST"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ttl_tpu_torch.ops import attention as fa
    flags, route = PATHS[args.path]
    cfg = cs.config(*flags)
    cs.log(f"{args.path} path, kernel route {route}; max |difference of the "
           f"logits| per image seed (bound in chip_smoke.py: "
           f"{cs.CARD_CPU_BOUND})")
    for seed in range(args.seeds[0], args.seeds[1] + 1):
        logits = {}
        for name, mode, device in (("cpu", route, "cpu"),
                                   ("kernel", route, "cuda"),
                                   ("einsum", "off", "cuda")):
            with cs.attention_route(fa, mode):
                logits[name] = cs.sample_step(cfg, image_seed=seed)(
                    torch.device(device))

        def diff(a, b):
            return (logits[a] - logits[b]).abs().max().item()

        top2 = logits["cpu"].topk(2).values
        cs.log(f"seed {seed}: kernel vs CPU {diff('kernel', 'cpu'):.4f}, "
               f"einsum on the card vs CPU {diff('einsum', 'cpu'):.4f}, "
               f"kernel vs einsum on the card {diff('kernel', 'einsum'):.4f}"
               f"; top-1 {int(logits['kernel'].argmax())} / "
               f"{int(logits['einsum'].argmax())} / "
               f"{int(logits['cpu'].argmax())}, CPU margin to the second "
               f"{(top2[0] - top2[1]).item():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
