"""Tile heights for the tensor-core attention kernels of `ttl_tpu_torch`.

`csrc/attention_mma.cuh` takes its tile heights as template parameters:
warps a block (16 rows each), rows a stage, stages in the cp.async ring. The
launcher uses (2, 32, 2) for heads of up to 32 tokens and, above, (4, 64, 2)
in the forward and (4, 32, 2) in the backward.
This script builds the bodies under other heights
(`tools/torch_attention_tiles.cu`), checks each against the plain version and
times forward and backward on both grids at the two shapes the text-side
paths give K3 and K4: [512, 12, 197, 64] and [1600, 8, 32, 64] causal, bf16.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 tools/torch_attention_tiles.py
"""
from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ttl_tpu_torch.ops import _build  # noqa: E402
from ttl_tpu_torch.ops import attention as fa  # noqa: E402

# (B, H, S, causal) and the (warps, rows a stage, stages) tried there
SHAPES = [
    (512, 12, 197, False,
     [(4, 64, 2), (4, 64, 3), (4, 64, 4), (8, 64, 2), (8, 64, 3), (4, 32, 2),
      (4, 32, 3), (8, 32, 2), (8, 32, 3), (2, 64, 2), (2, 64, 3)]),
    (1600, 8, 32, True,
     [(2, 32, 2), (2, 32, 3), (2, 32, 4), (1, 32, 2), (1, 32, 3), (4, 64, 2)]),
]


def median_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out_dir = os.path.join(ROOT, "build", "tiles")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libttl_tiles.so")
    t0 = time.perf_counter()
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib_path,
                    os.path.join(ROOT, "tools", "torch_attention_tiles.cu")],
                   check=True)
    print(f"built in {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    lib = ctypes.CDLL(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ttl_tiles_run.argtypes = [i, i, i, p, p, p, p, p, p, p, p, p, i, i, i,
                                  i, f, p]
    lib.ttl_tiles_run.restype = i
    for b, h, s, causal, tiles in SHAPES:
        g = torch.Generator().manual_seed(s)
        q, k, v, do = (torch.randn(b, h, s, 64, generator=g)
                       .to("cuda", torch.bfloat16) for _ in range(4))
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        stats = torch.empty(3, b * h * s, device="cuda")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa.attention_bhsd_plain(*leaves, causal)
        want = torch.autograd.grad(ref, leaves, do)
        ref = ref.detach()
        stream = torch.cuda.current_stream().cuda_stream
        for w, kt, ns in tiles:
            for heads in (0, 1):
                def call(bwd):
                    rc = lib.ttl_tiles_run(
                        100 * w + kt + ns, bwd, heads, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        o.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), stats.data_ptr(), b, h, s, int(causal),
                        1 / 8.0, stream)
                    if rc:
                        raise RuntimeError(f"({w}, {kt}, {ns}): code {rc}")
                for t in (o, dq, dk, dv):
                    t.zero_()
                call(0)
                call(1)
                torch.cuda.synchronize()
                err_f = (o.float() - ref.float()).abs().max().item()
                err_b = max((a.float() - x.float()).abs().max().item()
                            for a, x in zip((dq, dk, dv), want))
                print(f"[{b}, {h}, {s}, 64] causal={causal} "
                      f"{'heads' if heads else 'per_head'} warps {w}, rows a "
                      f"stage {kt}, stages {ns}: forward "
                      f"{median_ms(lambda: call(0)):.4f} ms, backward "
                      f"{median_ms(lambda: call(1)):.4f} ms, max_abs_err "
                      f"{err_f:.2e} / {err_b:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
