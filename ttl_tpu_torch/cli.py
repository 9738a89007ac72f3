"""`python -m ttl_tpu_torch DATA --test_sets A`: the reference CLI on CUDA.

Flags parse exactly as for `python -m ttl_tpu` (the JAX package's
`build_parser` and `config_from_args`). The run goes to `cuda:{--gpu}`;
without CUDA the CLI raises and never carries on on the CPU. Flags the port
does not cover yet raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import torch

from ttl_tpu.cli import build_parser, config_from_args


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
