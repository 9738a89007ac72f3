"""Build and load the package's CUDA kernels.

The sources under `ttl_tpu_torch/csrc/` are compiled with `nvcc` for Hopper
(`sm_90a`), one `nvcc` process per source, all started together, and linked
into one shared library with a plain C interface, loaded with ctypes. Each
compile runs with `-Xptxas -v`, and what ptxas says of every kernel
(registers, shared memory, spills) is kept in a text file beside the
library (`kernel_resources`). The
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
PTXAS_VERBOSE = ("-Xptxas", "-v")


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
    h.update(" ".join(NVCC_FLAGS + PTXAS_VERBOSE).encode())
    return BUILD_DIR / f"libttl_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; return their outputs, or raise with
    the output of any that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed, outputs = [], []
    for cmd, proc in procs:
        output = proc.communicate()[0]
        outputs.append(output)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{output}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outputs


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
        logs = _run([[nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", "-o", obj,
                      str(src)] for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        log = os.path.join(tmp, "ptxas.txt")
        Path(log).write_text("\n".join(
            f"{_SOURCE_MARK}{src.name}\n{text}"
            for src, text in zip(_sources(), logs)))
        os.replace(log, _resources_path(out))
        os.replace(lib, out)
    return out


_SOURCE_MARK = "== source "


def _resources_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def kernel_resources(name_part: str = "") -> dict[str, str]:
    """What ptxas reported for each kernel of the built library whose
    (mangled) name contains `name_part`: {'source.cu: name': 'Used N
    registers, ...; N bytes spill stores, N bytes spill loads'}. A header
    may be compiled into several sources: each has its own entry."""
    lines = _resources_path(build()).read_text().splitlines()
    found, source, name, spills = {}, "", None, ""
    for line in lines:
        if line.startswith(_SOURCE_MARK):
            source = line[len(_SOURCE_MARK):]
            continue
        text = line.split("ptxas info    : ", 1)[-1].strip()
        if text.startswith("Compiling entry function"):
            name, spills = text.split("'")[1], ""
        elif "spill stores" in text:
            spills = text
        elif text.startswith("Used ") and name is not None:
            if name_part in name:
                found[f"{source}: {name}"] = f"{text}; {spills}"
            name = None
    return found


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
    for route in ("per_head", "heads"):
        fwd = getattr(lib, f"ttl_{route}_attention_fwd")
        fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
        fwd.restype = i
        bwd = getattr(lib, f"ttl_{route}_attention_bwd")
        bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
        bwd.restype = i
    lib.ttl_bhsd_attention_route.argtypes = [i, i]
    lib.ttl_bhsd_attention_route.restype = i
    ll = ctypes.c_longlong
    lib.ttl_quant_matmul.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, p]
    lib.ttl_quant_matmul.restype = i
    lib.ttl_quant_matmul_scratch_bytes.argtypes = [i, i, i]
    lib.ttl_quant_matmul_scratch_bytes.restype = ll
    lib.ttl_ln_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.ttl_ln_matmul.restype = i
    lib.ttl_ln_matmul_max_k.argtypes = [i]
    lib.ttl_ln_matmul_max_k.restype = i
    lib.ttl_swiglu_fwd.argtypes = [p, p, i, ll, i, p]
    lib.ttl_swiglu_fwd.restype = i
    lib.ttl_swiglu_bwd.argtypes = [p, p, p, i, ll, i, p]
    lib.ttl_swiglu_bwd.restype = i
    lib.ttl_layer_norm_fwd.argtypes = [p, p, p, p, p, p, i, ll, i, i, f, i,
                                        p]
    lib.ttl_layer_norm_fwd.restype = i
    lib.ttl_layer_norm_bwd.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, p]
    lib.ttl_layer_norm_bwd.restype = i
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
