"""Build and load the package's CUDA kernels.

The sources under `ttl_tpu_torch/csrc/` are compiled with `nvcc` for Hopper
(`sm_90a`) into one shared library with a plain C interface, loaded with
ctypes. The build runs at the first kernel launch, never at import, and goes
into `build/kernels/` beside the package; the library's name carries a hash
of the sources, so an edited source is rebuilt and a stale library is never
loaded. A failed build raises: nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libttl_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builds never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ttl_bshd_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
    lib.ttl_bshd_attention_fwd.restype = i
    lib.ttl_bshd_attention_bwd.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, f, p]
    lib.ttl_bshd_attention_bwd.restype = i
    lib.ttl_cuda_error_string.argtypes = [i]
    lib.ttl_cuda_error_string.restype = ctypes.c_char_p
    return lib


CUDA_ERROR_INVALID_VALUE = 1


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc == 0:
        return
    if rc == CUDA_ERROR_INVALID_VALUE:
        # the wrappers validate every other argument before the call, so
        # this is the kernels refusing a geometry whose tiles do not fit
        raise NotImplementedError(
            f"{what}: the tiles exceed the 227 KB of shared memory a block "
            "may use; not ported yet (ROADMAP Queue 3)")
    msg = library().ttl_cuda_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
