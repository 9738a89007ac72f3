"""The process environment of a run, set before torch is imported: every
build and kernel cache inside the checkout at a fixed path (only the first
run of a checkout builds), and no JAX for libraries that would load it."""
from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHES = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TRITON_CACHE_DIR", "triton"),
          ("CUDA_CACHE_PATH", "cuda_cache"))


def configure() -> None:
    for var, sub in CACHES:
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
