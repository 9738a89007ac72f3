"""Tile shapes of K5's product, `k5_gemm_kernel` in `csrc/quant_matmul.cu`.

The kernel takes its block height BM and its warps along M and N (WM, WN)
as template parameters, the ring's K step (`kBK`) and depth (`kStages`) as
constants; the launcher takes one tile for every T. This script copies the
source under `build/k5_tiles/`, rewrites those constants and the tile of
the launch for each variant, builds each copy with nvcc, and times whole K5
calls (the three launches) with CUDA events at the int8 main path's and
zero-shot's shapes, bf16, in turns (variants forward, then backward), each
call checked bit for bit against `linear_q_plain` first.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 tools/torch_k5_tiles.py [--variants source 128,2,4,64,4 ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ttl_tpu_torch.ops import _build  # noqa: E402
from ttl_tpu_torch.ops import quant as tq  # noqa: E402

# (BM, WM, WN, K step in bytes, stages); "source": the tile of the source
# as it stands (128, 2, 2, 128, 3); 128,2,4,64,4 was the first design
DEFAULT = ["source", "128,2,4,64,4", "128,2,4,128,3", "128,2,2,64,4",
           "128,1,4,128,3", "256,4,2,128,3", "64,2,2,128,3", "64,2,4,64,4"]
# the int8 main path's K5 calls (q/k/v/o, fc1, fc2) and zero-shot's
SHAPES = [(cs.K5_ROWS, 768, 768), (cs.K5_ROWS, 768, 3072),
          (cs.K5_ROWS, 3072, 768), (8 * cs.SEQ_PAD, 768, 768),
          (8 * cs.SEQ_PAD, 768, 3072), (8 * cs.SEQ_PAD, 3072, 768)]
LAUNCH = re.compile(r"launch_gemm<T, \d+, \d+, \d+>\(")


def write_variant(name: str) -> tuple[str, list[str]]:
    """The source with the variant's constants and a fixed tile, under its
    own directory; returns the library's path and its nvcc command."""
    out = os.path.join(ROOT, "build", "k5_tiles", name.replace(",", "_"))
    os.makedirs(out, exist_ok=True)
    shutil.copy(_build.CSRC / "mma_sm90.cuh", out)
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    if name != "source":
        bm, wm, wn, bk, stages = (int(v) for v in name.split(","))
        src, n_bk = re.subn(r"constexpr int kBK = \d+;",
                            f"constexpr int kBK = {bk};", src)
        src, n_st = re.subn(r"constexpr int kStages = \d+;",
                            f"constexpr int kStages = {stages};", src)
        src, n = LAUNCH.subn(f"launch_gemm<T, {bm}, {wm}, {wn}>(", src)
        if (n_bk, n_st, n) != (1, 1, 1):
            raise RuntimeError("the constants or the launch of (G) were not "
                               "found")
    path = os.path.join(out, "quant_matmul.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libk5.so")
    return lib, [_build._nvcc(), *_build.NVCC_FLAGS, *_build.PTXAS_VERBOSE,
                 "-shared", "-o", lib, path]


def load(lib: str) -> ctypes.CDLL:
    dll = ctypes.CDLL(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.ttl_quant_matmul.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, p]
    dll.ttl_quant_matmul_scratch_bytes.argtypes = [i, i, i]
    dll.ttl_quant_matmul_scratch_bytes.restype = ll
    return dll


def call(dll, x, pq, y, scratch):
    t, k = x.shape
    rc = dll.ttl_quant_matmul(
        x.data_ptr(), pq["wq"].data_ptr(), pq["scale"].data_ptr(),
        pq["b"].data_ptr(), y.data_ptr(), scratch.data_ptr(), scratch.numel(),
        1, t, k, y.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=DEFAULT)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    built = {name: write_variant(name) for name in args.variants}
    logs = _build._run([cmd for _, cmd in built.values()])  # side by side
    for name, log in zip(built, logs):
        gemm = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                gemm = "k5_gemm" in line and "nv_bfloat16" in line
            elif gemm and "Used " in line:
                print(f"ptxas, bf16 (G) of {name}: "
                      f"{line.split(': ', 1)[1].strip()}", flush=True)
                gemm = None
    libs = {name: load(lib) for name, (lib, _) in built.items()}
    g = torch.Generator().manual_seed(cs.SEED + 5)
    for t, k, n in SHAPES:
        x = torch.randn(t, k, generator=g).to("cuda", torch.bfloat16)
        pq = tq.quantize_linear({
            "w": (torch.randn(k, n, generator=g) * 0.02).cuda(),
            "b": (torch.randn(n, generator=g) * 0.02).cuda()})
        want = tq.linear_q_plain(x, pq)
        y = torch.empty_like(want)
        scratch = torch.empty(
            max(lib.ttl_quant_matmul_scratch_bytes(t, k, n)
                for lib in libs.values()), dtype=torch.uint8, device="cuda")
        times = {name: [] for name in args.variants}
        for order in (args.variants, args.variants[::-1]):
            for name in order:
                y.zero_()
                call(libs[name], x, pq, y, scratch)
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version at [{t}, {k}] x [{k}, {n}]")
                times[name].append(cs.median_ms(
                    lambda: call(libs[name], x, pq, y, scratch)))
        print(f"[{t}, {k}] x [{k}, {n}] bf16, K5 ms (two turns; BM, WM, "
              "WN, K step, stages):", flush=True)
        for name, ts in times.items():
            print(f"  {name}: {ts[0]:.4f} / {ts[1]:.4f} (mean "
                  f"{statistics.mean(ts):.4f})", flush=True)
        del x, y, want, scratch
    return 0


if __name__ == "__main__":
    sys.exit(main())
