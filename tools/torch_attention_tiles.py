"""Tile heights and old bodies for the tensor-core attention of `ttl_tpu_torch`.

`csrc/attention_mma.cuh` takes its tile heights as template parameters:
warps a block (16 rows each), rows a stage, stages in the cp.async ring. The
launcher's rule (`mma_attention_fwd` / `_bwd`) picks them from S. This
script builds the bodies under other heights (`tools/torch_attention_tiles.cu`)
and, each section on the same inputs in one process, with CUDA events:

- `tiles`: forward and backward on K3's and K4's grids at the two shapes
  the text-side paths give them, [512, 12, 197, 64] and [1600, 8, 32, 64]
  causal, bf16, under every height built;
- `wide`: the forward with 4 and with 8 warps a block (64 and 128 query
  rows), on K3's and K4's [B, H, S, D] grids and on K1's [B, S, H*D] rows,
  at every S the paths launch (32, 64, 197, 208, 272, 592);
- `d128`: K1 and K2 at head dim 128 on AIMv2-L/14's rows, [512, 256,
  1024] bf16 in 8 heads, under every height built for it, each checked
  against the plain version, in turns (each height, then again backwards);
- `parent` (with `--parent DIR`, the root of a checkout of another commit,
  for example `git archive` of the parent unpacked under build/): K1 and K2
  of this checkout against that checkout's `csrc/attention_bshd.cu` at the
  bf16 geometries of the towers, timed in turns (parent, this, this,
  parent), each checked against the plain version.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 tools/torch_attention_tiles.py [--sections tiles wide d128
        parent] [--parent DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
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
LAYOUTS = {0: "per_head [B, H, S, D]", 1: "heads [B, H, S, D]",
           2: "bshd [B, S, H*D]"}
# the `wide` section: (B, H, S, true tokens of a bshd row) at every S the
# paths launch; S = 32 is the causal text tower on the [B, H, S, D] grids
WIDE = [(1600, 8, 32, 32), (512, 12, 64, 50), (512, 12, 197, 197),
        (512, 12, 208, 197), (64, 16, 272, 257), (16, 16, 592, 577)]
# the `parent` section: K1/K2's bf16 geometries (B, S, true tokens, H,
# width): ViT-B/16, ViT-L/14, ViT-L/14@336px
PARENT = [(512, 208, 197, 12, 768), (64, 272, 257, 16, 1024),
          (16, 592, 577, 16, 1024)]
# the `d128` section: (B, S, H) and the heights tried forward and backward
D128 = (512, 256, 8)
D128_FWD = [(4, 64, 2), (8, 64, 2), (4, 32, 2), (8, 32, 2)]
D128_BWD = [(4, 32, 2), (2, 32, 2), (4, 16, 2), (4, 32, 3)]


def nvcc_shared(out: str, source: str) -> float:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    t0 = time.perf_counter()
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", out, source],
                   check=True)
    return time.perf_counter() - t0


def randn(*shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)


class Tiles:
    """The bodies under the heights `ttl_tiles_run` was built with."""

    def __init__(self, out_dir: str):
        path = os.path.join(out_dir, "libttl_tiles.so")
        secs = nvcc_shared(path, os.path.join(ROOT, "tools",
                                              "torch_attention_tiles.cu"))
        cs.log(f"built the tile bodies in {secs:.1f} s")
        self.lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.ttl_tiles_run.argtypes = [i, i, i, p, p, p, p, p, p, p, p,
                                           p, i, i, i, i, i, f, p]
        self.lib.ttl_tiles_run.restype = i
        self.lib.ttl_tiles_run_d128.argtypes = [i, i, p, p, p, p, p, p, p,
                                                p, p, i, i, i, i, f, p]
        self.lib.ttl_tiles_run_d128.restype = i

    def call(self, tiles, bwd, layout, q, k, v, do, outs, stats, b, h, s,
             seq_len, causal):
        w, kt, ns = tiles
        rc = self.lib.ttl_tiles_run(
            100 * w + kt + ns, bwd, layout, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), *(t.data_ptr() for t in outs),
            stats.data_ptr(), b, h, s, seq_len, int(causal), 1 / 8.0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{tiles} on layout {layout}: code {rc}")


    def call_d128(self, tiles, bwd, q, k, v, do, outs, stats, b, h, s):
        w, kt, ns = tiles
        rc = self.lib.ttl_tiles_run_d128(
            100 * w + kt + ns, bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), *(t.data_ptr() for t in outs), stats.data_ptr(),
            b, h, s, s, 128 ** -0.5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{tiles} at head dim 128: code {rc}")


def section_d128(tl: Tiles) -> None:
    """K1 and K2 at head dim 128 under each height, in turns."""
    b, s, h = D128
    q, k, v, do = (randn(b, s, h * 128, seed=s + i) for i in range(4))
    outs = [torch.empty_like(q) for _ in range(4)]   # o, dq, dk, dv
    stats = torch.empty(3, b * h * s, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.attention_bshd_plain(*leaves, h, s)
    want = torch.autograd.grad(ref, leaves, do)
    ref = ref.detach().float()
    for bwd, heights in ((0, D128_FWD), (1, D128_BWD)):
        times = {}
        for tiles in heights + heights[::-1]:
            def call():
                tl.call_d128(tiles, bwd, q, k, v, do, outs, stats, b, h, s)
            for t in outs:
                t.zero_()
            call()
            torch.cuda.synchronize()
            if bwd:
                err = max(((a.float() - x.float()).abs().max()
                           / x.float().abs().max()).item()
                          for a, x in zip(outs[1:], want))
                limit = cs.BWD_BOUND_REL[torch.bfloat16]
            else:
                err = ((outs[0].float() - ref).abs().max()
                       / max(1.0, ref.abs().max().item())).item()
                limit = cs.FWD_BOUND[torch.bfloat16]
            if not err <= limit:
                raise AssertionError(f"{tiles} at head dim 128: {err}")
            times.setdefault(tiles, []).append(cs.median_ms(call))
        cs.log(f"K{2 if bwd else 1} [{b}, {s}, {h * 128}] bf16, {h} heads of "
               f"128: " + ", ".join(
                   f"{w} warps, {kt} rows a stage, {ns} stages "
                   f"{min(t):.4f} ms ({'/'.join(f'{x:.4f}' for x in t)})"
                   for (w, kt, ns), t in times.items()))


def section_tiles(tl: Tiles) -> None:
    for b, h, s, causal, tiles in SHAPES:
        q, k, v, do = (randn(b, h, s, 64, seed=s + i) for i in range(4))
        outs = [torch.empty_like(q) for _ in range(4)]   # o, dq, dk, dv
        stats = torch.empty(3, b * h * s, device="cuda")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa.attention_bhsd_plain(*leaves, causal)
        want = torch.autograd.grad(ref, leaves, do)
        ref = ref.detach()
        for w, kt, ns in tiles:
            for layout in (0, 1):
                def call(bwd):
                    tl.call((w, kt, ns), bwd, layout, q, k, v, do, outs,
                            stats, b, h, s, s, causal)
                for t in outs:
                    t.zero_()
                call(0)
                call(1)
                torch.cuda.synchronize()
                err_f = (outs[0].float() - ref.float()).abs().max().item()
                err_b = max((a.float() - x.float()).abs().max().item()
                            for a, x in zip(outs[1:], want))
                cs.log(f"[{b}, {h}, {s}, 64] causal={causal} "
                       f"{LAYOUTS[layout]} warps {w}, rows a stage {kt}, "
                       f"stages {ns}: forward "
                       f"{cs.median_ms(lambda: call(0)):.4f} ms, backward "
                       f"{cs.median_ms(lambda: call(1)):.4f} ms, max_abs_err "
                       f"{err_f:.2e} / {err_b:.2e}")


def section_wide(tl: Tiles) -> None:
    """The forward with 4 and 8 warps a block, in turns (4, 8, 8, 4)."""
    for b, h, s, seq_len in WIDE:
        heights = [(2, 32, 2)] if s <= 32 else []
        heights += [(4, 64, 2), (8, 64, 2)]
        for layout in (0, 1, 2):
            causal = s == 32 and layout != 2
            rows = layout == 2
            n = seq_len if rows else s
            shape = (b, s, h * 64) if rows else (b, h, s, 64)
            q, k, v = (randn(*shape, seed=s + i) for i in range(3))
            o = torch.empty_like(q)
            ref = (fa.attention_bshd_plain(q, k, v, h, seq_len) if rows
                   else fa.attention_bhsd_plain(q, k, v, causal))
            times = {}
            for tiles in heights + heights[::-1]:
                def call():
                    tl.call(tiles, 0, layout, q, k, v, q, (o, o, o, o), o, b,
                            h, s, n, causal)
                o.zero_()
                call()
                torch.cuda.synchronize()
                valid = o[:, :seq_len] if rows else o
                err = (valid.float() - (ref[:, :seq_len] if rows else ref)
                       .float()).abs().max().item()
                limit = cs.FWD_BOUND[torch.bfloat16] * max(
                    1.0, ref.float().abs().max().item())
                if not err <= limit:
                    raise AssertionError(f"{tiles} at {shape}: {err}")
                times.setdefault(tiles, []).append(cs.median_ms(call))
            cs.log(f"forward {LAYOUTS[layout]} {list(shape)}"
                   f"{f', {seq_len} true tokens' if rows else ''}"
                   f"{', causal' if causal else ''}: " + ", ".join(
                       f"{w} warps ({16 * w} rows) {min(t):.4f} ms "
                       f"({'/'.join(f'{x:.4f}' for x in t)})"
                       for (w, _, _), t in times.items()))
            del q, k, v, o, ref


def section_parent(parent: str, out_dir: str) -> None:
    """K1/K2 of this checkout against `parent`'s attention_bshd.cu."""
    path = os.path.join(out_dir, "libparent_bshd.so")
    secs = nvcc_shared(path, os.path.join(parent, "ttl_tpu_torch", "csrc",
                                          "attention_bshd.cu"))
    cs.log(f"built {parent}'s attention_bshd.cu in {secs:.1f} s")
    old = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.ttl_bshd_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
    old.ttl_bshd_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, f, p]
    old.ttl_bshd_attention_route.argtypes = [i, i, i, i]
    routes = ("tensor cores (WMMA)", "whole-head FMA", "key-tiled FMA")
    for b, s, seq_len, h, width in PARENT:
        q, k, v, do = (randn(b, s, width, seed=s + i) for i in range(4))
        d = width // h
        scale = 1.0 / d ** 0.5
        o = torch.empty_like(q)
        grads = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty(3, b * h * s, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def old_fwd():
            old.ttl_bshd_attention_fwd(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), o.data_ptr(), 1, b, s,
                                       h, d, seq_len, scale, stream)
            return o

        def old_bwd():
            old.ttl_bshd_attention_bwd(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), do.data_ptr(),
                                       *(t.data_ptr() for t in grads),
                                       stats.data_ptr(), 1, b, s, h, d,
                                       seq_len, scale, stream)
            return grads

        bodies = {
            "fwd": {"parent": old_fwd,
                    "this": lambda: fa.bshd_forward_cuda(q, k, v, h,
                                                         seq_len)},
            "bwd": {"parent": old_bwd,
                    "this": lambda: fa.bshd_backward_cuda(q, k, v, do, h,
                                                          seq_len)}}
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa.attention_bshd_plain(*leaves, h, seq_len)
        want = torch.autograd.grad(ref, leaves, do)
        ref = ref.detach().float()
        for kind, pair in bodies.items():
            route = {"parent": routes[old.ttl_bshd_attention_route(
                         int(kind == "bwd"), 1, s, d)],
                     "this": fa.kernel_route(kind == "bwd", torch.bfloat16,
                                             s, d)}
            times = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                got = pair[who]()
                torch.cuda.synchronize()
                if kind == "fwd":
                    err = (got.float() - ref)[:, :seq_len].abs().max().item()
                    ok = err <= cs.FWD_BOUND[torch.bfloat16] * max(
                        1.0, ref.abs().max().item())
                else:
                    err = max((g.float() - w.float())[:, :seq_len].abs().max()
                              .item() / w.float().abs().max().item()
                              for g, w in zip(got, want))
                    ok = err <= cs.BWD_BOUND_REL[torch.bfloat16]
                if not ok:
                    raise AssertionError(f"{who} {kind} at [{b}, {s}, "
                                         f"{width}]: {err}")
                times[who].append(cs.median_ms(pair[who]))
            cs.log(f"K{1 if kind == 'fwd' else 2} [{b}, {s}, {width}] bf16, "
                   f"{seq_len} true tokens: parent ({route['parent']}) "
                   f"{'/'.join(f'{t:.4f}' for t in times['parent'])} ms, "
                   f"this checkout ({route['this']}) "
                   f"{'/'.join(f'{t:.4f}' for t in times['this'])} ms")
        del q, k, v, do, o, grads, stats, leaves, ref, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", nargs="+", default=["tiles", "wide",
                                                      "parent"],
                    choices=["tiles", "wide", "d128", "parent"])
    ap.add_argument("--parent", help="root of a checkout of another commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs.log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    out_dir = os.path.join(ROOT, "build", "tiles")
    os.makedirs(out_dir, exist_ok=True)
    if {"tiles", "wide", "d128"} & set(args.sections):
        tl = Tiles(out_dir)
        if "tiles" in args.sections:
            section_tiles(tl)
        if "wide" in args.sections:
            section_wide(tl)
        if "d128" in args.sections:
            section_d128(tl)
    if "parent" in args.sections and args.parent:
        section_parent(args.parent, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
