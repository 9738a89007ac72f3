"""Build and load the package's CUDA kernels.

The sources under `ttl_tpu_torch/csrc/` are compiled with `nvcc` for Hopper
(`sm_90a`), one `nvcc` process per source, all started together, and linked
into one shared library with a plain C interface, loaded with ctypes. The
build runs at the first kernel launch, never at import, and goes into
`build/kernels/` beside the package; the library's name carries a hash of
the sources, so an edited source is rebuilt and a stale library is never
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
              "-Xcompiler", "-fPIC")


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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of any that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{output}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources unless the library for them exists; return it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under a private directory, then rename: concurrent builds never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ttl_bshd_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
    lib.ttl_bshd_attention_fwd.restype = i
    lib.ttl_bshd_attention_bwd.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, f, p]
    lib.ttl_bshd_attention_bwd.restype = i
    lib.ttl_bshd_attention_route.argtypes = [i, i, i, i]
    lib.ttl_bshd_attention_route.restype = i
    lib.ttl_quant_matmul.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.ttl_quant_matmul.restype = i
    lib.ttl_cuda_error_string.argtypes = [i]
    lib.ttl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error. The wrappers
    validate their arguments first, and every geometry has a route that fits
    shared memory, so any error here is a fault."""
    if rc == 0:
        return
    msg = library().ttl_cuda_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
