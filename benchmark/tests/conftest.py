"""Tests of the benchmark. On the CPU they run the harness at the port's
`test-tiny` sizes; the tests marked `cuda` run a cell at its own size and
skip where there is no card:

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -m cuda -q    # on the card
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_VISION = {"hidden_size": 32, "num_hidden_layers": 4,
               "num_attention_heads": 2, "intermediate_size": 128,
               "patch_size": 16, "image_size": 64}
TINY_TEXT = {"hidden_size": 32, "num_hidden_layers": 4,
             "num_attention_heads": 2, "intermediate_size": 128,
             "vocab_size": 49408, "max_position_embeddings": 77}


def tiny_cell(name: str, dtype: str = "float32", views: int = 8):
    """A cell cut to the port's `test-tiny` tower: small images, few views,
    a small check, float32 by default."""
    from benchmark.harness.manifest import Cell, load_cell

    cell = load_cell(name)
    config = copy.deepcopy(cell.config)
    config.update(program_arch="test-tiny", projection_dim=16,
                  vision=dict(TINY_VISION), text=dict(TINY_TEXT))
    config["ttl"].update(views=views, lora_layers=[1, 3],
                         compute_dtype=dtype, param_dtype=dtype)
    traffic = dict(cell.traffic, long_side_px=[100, 160], canvas=160,
                   distinct_images=16)
    if traffic["driver"] == "serve":
        # load that fills most steps, so that every batch position is used
        traffic.update(rate_per_s=120.0, max_delay_ms=50.0, max_queue=256,
                       warmup_waves=1)
    check = dict(cell.check, sample=32, block=8)
    return Cell(cell.name, 1, config, traffic, check, cell.end_to_end,
                cell.per_layer)


def run_cpu(cell, seed: int = 2 ** 31 + 77, seconds: float = 2.0,
            tmp_path=None, control=None) -> dict:
    """The rest of a run on the CPU: driver, window, check."""
    import time

    import torch

    from benchmark.harness import session

    torch.set_num_threads(2)
    return session.execute(cell, seed, seconds, False, torch.device("cpu"),
                           time.time(), str(tmp_path), control=control)


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
