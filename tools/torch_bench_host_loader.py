#!/usr/bin/env python
"""Host input-pipeline throughput of the PyTorch port's loader.

The counterpart of tools/bench_host_loader.py: synthesizes N JPEGs shaped
like ImageNet's validation images (500x375, quality 85, from seed 0) in a
temporary directory, then measures `ttl_tpu_torch.data.views.SampleLoader`
end to end on the host (decode, canvas packing, the prefetch thread):

  - with the native threaded libjpeg decoder (data/native_decode.py),
  - with it disabled (the PIL path every other format takes).

No device is used. Prints a line for each, then one JSON line.

Usage: python tools/torch_bench_host_loader.py [--n 2000] [--workers 4]
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def synth_jpegs(root: str, n: int) -> list:
    from PIL import Image
    rng = np.random.RandomState(0)
    # a small pool of textures re-encoded at slightly different sizes:
    # decode cost follows pixel count and entropy, not file identity
    base = [
        np.clip(rng.rand(375, 500, 3) * 255 * (0.5 + 0.5 * rng.rand()),
                0, 255).astype(np.uint8) for _ in range(32)
    ]
    paths = []
    for i in range(n):
        h = 375 + (i % 7) * 11
        w = 500 - (i % 5) * 13
        p = os.path.join(root, f"img_{i:05d}.jpg")
        Image.fromarray(base[i % len(base)]).resize((w, h)).save(p,
                                                                 quality=85)
        paths.append(p)
    return paths


class PathDataset:
    def __init__(self, paths):
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        return self.paths[i], 0


def measure(dataset, batch_size: int, workers: int, label: str) -> float:
    """Samples/s of one pass of SampleLoader over `dataset`."""
    from ttl_tpu_torch.data.views import SampleLoader
    loader = SampleLoader(dataset, batch_size=batch_size, shuffle=True,
                          seed=0, workers=workers)
    n = 0
    t0 = time.perf_counter()
    for batch in loader:
        n += batch.canvases.shape[0] - batch.pad
    dt = time.perf_counter() - t0
    print(f"{label:28} {n / dt:8.1f} samples/s  "
          f"({1000 * dt / n:6.2f} ms/sample)", flush=True)
    return n / dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)

    from ttl_tpu_torch.data import native_decode

    out = {"metric": "host samples/s of SampleLoader (decode + canvas)",
           "n": args.n, "workers": args.workers, "batch": args.batch,
           "cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = synth_jpegs(root, args.n)
        print(f"synthesized {len(paths)} jpegs in "
              f"{time.perf_counter() - t0:.1f}s "
              f"(~{os.path.getsize(paths[0]) // 1024}KB each)", flush=True)
        ds = PathDataset(paths)
        out["native_available"] = native_decode.available()
        if out["native_available"]:
            out["native_sps"] = round(measure(
                ds, args.batch, args.workers,
                f"native ({args.workers} threads)"), 3)
        orig = native_decode.available
        native_decode.available = lambda: False
        try:
            out["pil_sps"] = round(measure(ds, args.batch, args.workers,
                                           "PIL fallback"), 3)
        finally:
            native_decode.available = orig
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
