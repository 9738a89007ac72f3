"""ctypes binding for the native JPEG decode/canvas-pack library.

Builds native/libttl_decode.so on first use (g++ + libjpeg, both baked into
the image) and exposes `decode_batch`; SampleLoader uses it for whole-JPEG
batches and falls back to the PIL path per-file on any failure, so the
framework keeps working without a toolchain.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# source checkout layout (repo_root/native); wheel installs have no native
# dir and fall back to PIL unless TTL_NATIVE_DIR points at the sources
_NATIVE_DIR = Path(os.environ.get(
    "TTL_NATIVE_DIR",
    Path(__file__).resolve().parent.parent.parent / "native"))
_SO = _NATIVE_DIR / "libttl_decode.so"


@functools.lru_cache()
def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("TTL_NATIVE_DECODE", "1") in ("0", "false"):
        return None
    try:
        if not _SO.exists() or (_SO.stat().st_mtime
                                < (_NATIVE_DIR / "ttl_decode.cpp"
                                   ).stat().st_mtime):
            subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR)],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return None
    lib.ttl_decode_batch.restype = ctypes.c_int
    lib.ttl_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    return lib


def available() -> bool:
    return _load() is not None


def decode_batch(paths: Sequence[str], canvases: np.ndarray,
                 heights: np.ndarray, widths: np.ndarray,
                 n_threads: int = 4) -> np.ndarray:
    """Decode `paths` into canvases[i] (uint8 [N,S,S,3], zeroed on entry by
    the library). Returns a boolean mask of successful decodes; failed
    entries keep heights[i] == 0 for the caller's fallback."""
    lib = _load()
    n = len(paths)
    assert lib is not None and canvases.flags.c_contiguous
    hs = np.zeros((n,), np.int32)
    ws = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ttl_decode_batch(
        c_paths, n,
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        canvases.shape[1],
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    heights[: n] = hs
    widths[: n] = ws
    return hs > 0
