"""Tile shapes of K6's bf16 body, `ln_matmul_wgmma_kernel` in
`csrc/ln_matmul.cu`.

The source names its tile in seven constants: the rows of the tall tile
(`kRowsTall`, 128 = two consumer warpgroups; the launcher takes it where it
and the ring fit, else 64 rows), the columns of an N tile and of a w slice
(`kBN`), the N of one wgmma (`kWN`: 64, 128 or 256), the rows of a w slice
(`kBK`), the ring's depth (`kStages`), the commit groups a warpgroup keeps
in flight before it releases a slice (`kInFlight`, 0 or 1), and whether row
tiles start their walk over the N tiles at different tiles (`kRotate`). A
variant names the first five or more of them, in that order; the others are
the source's. This script copies the source
under `build/k6_tiles/`, rewrites those constants for each variant, builds
each copy with nvcc side by side, checks each against `ln_matmul_plain`
within `chip_smoke.K6_BOUND`, and times whole K6 calls (the f32 epilogue)
with CUDA events at `chip_smoke.K6_SHAPES`' bf16 entries, in turns
(variants forward, then backward). Each line names the rows a tile took at
that shape.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 tools/torch_k6_tiles.py [--variants source 128,256,256,16,4,0,1 ...]
        [--shapes 106496,768,256 ...]
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
from ttl_tpu_torch.ops import ln_matmul as tlm  # noqa: E402

NAMES = ("kRowsTall", "kBN", "kWN", "kBK", "kStages", "kInFlight", "kRotate")
# (rows of the tall tile, N tile, N of a wgmma, slice rows, stages, groups
# in flight, rotation); "source": the source as it stands
DEFAULT = ["source", "128,256,256,16,4,0,1", "128,128,128,32,4,1,1",
           "128,128,128,32,4,0,0", "128,128,128,32,3,0,1",
           "128,128,128,64,2,0,1", "128,128,64,32,4,0,1",
           "128,128,128,16,8,0,1", "128,64,64,64,4,0,1",
           "64,128,128,64,8,0,1"]
SHAPES = [(m, k, n) for m, k, n, dtype in cs.K6_SHAPES
          if dtype == torch.bfloat16]
MAX_SMEM = 232448


def tile_of(name: str) -> dict:
    src = (_build.CSRC / "ln_matmul.cu").read_text()
    tile = {v: int(re.search(rf"constexpr int {v} = (\d+);", src).group(1))
            for v in NAMES}
    if name != "source":
        tile.update(zip(NAMES, (int(v) for v in name.split(","))))
    return tile


def rows_taken(tile: dict, k: int) -> int:
    """The launcher's route rule (`wgmma_smem` of the source)."""
    bm, kp = tile["kRowsTall"], (k + 63) // 64 * 64
    smem = (1024 + bm * kp * 2
            + tile["kStages"] * tile["kBK"] * tile["kBN"] * 2
            + 16 * tile["kStages"] + 8)
    return bm if smem <= MAX_SMEM else 64


def write_variant(name: str) -> tuple[str, list[str]]:
    """The source with the variant's constants, under its own directory;
    returns the library's path and its nvcc command."""
    out = os.path.join(ROOT, "build", "k6_tiles", name.replace(",", "_"))
    os.makedirs(out, exist_ok=True)
    for header in ("layer_norm.cuh", "mma_sm90.cuh", "wgmma_sm90.cuh"):
        shutil.copy(_build.CSRC / header, out)
    src = (_build.CSRC / "ln_matmul.cu").read_text()
    for var, value in tile_of(name).items():
        src, n = re.subn(rf"constexpr int {var} = \d+;",
                         f"constexpr int {var} = {value};", src)
        if n != 1:
            raise RuntimeError(f"constant {var} not found in ln_matmul.cu")
    path = os.path.join(out, "ln_matmul.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libk6.so")
    return lib, [_build._nvcc(), *_build.NVCC_FLAGS, *_build.PTXAS_VERBOSE,
                 "-shared", "-o", lib, path]


def load(lib: str) -> ctypes.CDLL:
    dll = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ttl_ln_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    dll.ttl_ln_matmul.restype = i
    return dll


def call(dll, x, scale, bias, w, b, out):
    m, k = x.shape
    rc = dll.ttl_ln_matmul(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), 1, 0, 0, m, k, out.shape[1], 1e-5,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=DEFAULT)
    ap.add_argument("--shapes", nargs="+", default=[
        ",".join(map(str, s)) for s in SHAPES], help="M,K,N, bf16")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    built = {name: write_variant(name) for name in args.variants}
    logs = _build._run([cmd for _, cmd in built.values()])  # side by side
    for name, log in zip(built, logs):
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = re.search(r"ln_matmul_wgmma_kernelILi(\d+)", line)
            elif kernel and "Used " in line:
                print(f"ptxas of {name}, {kernel.group(1)}-row tile: "
                      f"{line.split(': ', 1)[1].strip()}", flush=True)
                kernel = None
            elif kernel and "spill" in line:
                print(f"  {line.strip()}", flush=True)
    libs = {name: load(lib) for name, (lib, _) in built.items()}
    g = torch.Generator().manual_seed(cs.SEED + 6)
    for m, k, n in (map(int, s.split(",")) for s in args.shapes):
        x = (torch.randn(m, k, generator=g) * 2.0 + 0.5).to("cuda",
                                                           torch.bfloat16)
        scale = (1.0 + 0.1 * torch.randn(k, generator=g)).cuda()
        bias = (0.1 * torch.randn(k, generator=g)).cuda()
        w = (torch.randn(k, n, generator=g) * 0.05).to("cuda", torch.bfloat16)
        b = (0.1 * torch.randn(n, generator=g)).cuda()
        want = tlm.ln_matmul_plain(x, scale, bias, w, b)
        limit = cs.K6_BOUND[torch.bfloat16] * max(
            1.0, want.float().abs().max().item())
        out = torch.empty_like(want)
        times = {name: [] for name in args.variants}
        for order in (args.variants, args.variants[::-1]):
            for name in order:
                out.zero_()
                call(libs[name], x, scale, bias, w, b, out)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                if not err <= limit:
                    raise AssertionError(
                        f"{name} differs from the plain version at [{m}, "
                        f"{k}] x [{k}, {n}]: {err} > {limit}")
                times[name].append(cs.median_ms(
                    lambda: call(libs[name], x, scale, bias, w, b, out)))
        print(f"[{m}, {k}] x [{k}, {n}] bf16, K6 ms (two turns; rows, N "
              "tile, N a wgmma, slice rows, stages, in flight, rotation):",
              flush=True)
        for name, ts in times.items():
            mean = statistics.mean(ts)
            print(f"  {name} ({rows_taken(tile_of(name), k)} rows): "
                  f"{ts[0]:.4f} / {ts[1]:.4f} (mean {mean:.4f}, "
                  f"{2e-9 * m * k * n / mean:.1f} TFLOP/s)", flush=True)
        del x, w, out, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
