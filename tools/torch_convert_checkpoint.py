"""Convert a torch CLIP checkpoint to the fast-loading .npz pytree cache,
with the PyTorch port alone.

Usage:
    python tools/torch_convert_checkpoint.py SRC [--arch ViT-B/16] [--out clip.npz]

The counterpart of tools/convert_checkpoint.py, on
`ttl_tpu_torch.models.convert`: SRC can be a HuggingFace CLIPModel
.bin/.safetensors (requires --arch) or an OpenAI clip .pt (architecture
shape-inferred). The .npz holds the JAX package's layout under its keys, so
`--checkpoint_path clip.npz` loads it in either package. Converting is host
work (numpy and torch on the CPU): no device is used.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src")
    p.add_argument("--arch", default=None,
                   help="arch name (required for HF-layout checkpoints)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from ttl_tpu_torch.models.convert import (load_checkpoint,
                                              params_from_numpy, save_pytree)
    from ttl_tpu_torch.models.zoo import get_arch

    cfg = get_arch(args.arch) if args.arch else None
    tree, cfg = load_checkpoint(args.src, cfg)
    params = params_from_numpy(tree, "cpu")
    out = args.out or str(Path(args.src).with_suffix(".npz"))
    save_pytree(out, params)

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return node.numel()

    print(f"wrote {out}: {count(params)/1e6:.1f}M params, "
          f"vision={type(cfg.vision).__name__}")


if __name__ == "__main__":
    main()
