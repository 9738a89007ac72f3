"""Where a cell's set-up goes, part by part, on the card.

    python benchmark/tools/setup_parts.py [--workload vitb16-offline ...]

Times, in one process and in the order `predict` runs them, the program's
set-up calls for each cell's configuration: the seeded random weights
(`runner.load_model`), the class table (`build_text_classifier`), and the
first and second fused steps over a batch of the cell's JPEGs (the first
loads the kernel library and warms cuBLAS). One JSON line a cell.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.configure()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import images  # noqa: E402
from benchmark.harness.device import require_cards  # noqa: E402
from benchmark.harness.manifest import load_cell  # noqa: E402
from benchmark.harness.program import classnames, program_config  # noqa


def parts(cell, device, seed: int) -> dict:
    from ttl_tpu_torch.adapt.ttl import compute_dtype, make_fused_ttl_fn
    from ttl_tpu_torch.models.prompts import (build_text_classifier,
                                              prompt_tokens)
    from ttl_tpu_torch.runner import (full_f32_products, load_model,
                                      make_adapters0, sample_draws)

    def clock():
        torch.cuda.synchronize(device)
        return time.perf_counter()

    cfg = program_config(cell, seed)
    out = {"workload": cell.name}
    t = clock()
    full_f32_products(device)
    clip_cfg, params = load_model(cfg, device)
    out["weights_s"] = (t2 := clock()) - t
    names = classnames(cell.traffic)
    toks = prompt_tokens(names, cfg.ctx_init.replace("_", " "))
    text_cls = build_text_classifier(params["text"], toks, clip_cfg.text,
                                     device=device,
                                     compute_dtype=compute_dtype(cfg))
    out["class_table_s"] = (t3 := clock()) - t2
    with tempfile.TemporaryDirectory() as tmp:
        files = images.write_set(seed, cfg.sample_batch,
                                 *cell.traffic["long_side_px"], tmp)
        canv = np.zeros((cfg.sample_batch, 512, 512, 3), np.uint8)
        hs, ws = [], []
        for k, path in enumerate(files):
            img = images.decode(path)
            canv[k, :img.shape[0], :img.shape[1]] = img
            hs.append(img.shape[0])
            ws.append(img.shape[1])
    out["images_s"] = (t4 := clock()) - t3
    canv_d = torch.from_numpy(canv).to(device)
    hs_d = torch.tensor(hs, dtype=torch.int32, device=device)
    ws_d = torch.tensor(ws, dtype=torch.int32, device=device)
    adapters0 = make_adapters0(cfg, clip_cfg, device)
    step = make_fused_ttl_fn(clip_cfg, cfg, zero_shot_aux=True)
    draws = {k: v.to(device) for k, v in
             sample_draws(cfg, np.arange(cfg.sample_batch)).items()}

    def run():
        return step(params, text_cls, adapters0, canv_d, hs_d, ws_d,
                    draws).logits
    run()
    out["first_step_s"] = (t5 := clock()) - t4
    run()
    out["second_step_s"] = clock() - t5
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+",
                    default=["vitb16-offline", "vitl14-offline"])
    ap.add_argument("--seed", type=int, default=3_500_000_000)
    args = ap.parse_args()
    device = require_cards(1)
    for name in args.workload:
        print(json.dumps(parts(load_cell(name), device, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
