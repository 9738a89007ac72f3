#!/usr/bin/env python
"""Cold start of the PyTorch port's HTTP server.

The counterpart of tools/serve_coldstart.py: the seconds from starting
`python -m ttl_tpu_torch.serve` to its READY line ("... serving on ..."),
then the seconds to the answer of its first request (one 224x224 JPEG from
seed 0). Each run is a fresh process; the first also builds the kernels
where the build directory has none. The server runs on the card only.

Usage: python tools/torch_serve_coldstart.py [--arch ViT-B/16] [--runs 2]

Prints one JSON line; exits 1 when no run reached its READY line.
"""
import argparse
import io
import json
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

READY = "serving on"


def server_cmd(args, port: int) -> list:
    cmd = [sys.executable, "-m", "ttl_tpu_torch.serve", "--port", str(port),
           "--arch", args.arch, "--sample_batch", str(args.sample_batch)]
    if args.arch == "test-tiny":
        cmd += ["--resolution", "64"]
    return cmd


def one_run(args) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(server_cmd(args, port), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, cwd=ROOT)
    try:
        # the READY line, watched from a thread, so that --timeout holds
        # while the server prints nothing
        ready_at = []
        done = threading.Event()

        def watch():
            for line in proc.stdout:
                if READY in line:
                    ready_at.append(time.perf_counter() - t0)
                    break
            done.set()  # READY, or the process ended

        threading.Thread(target=watch, daemon=True).start()
        done.wait(args.timeout)
        if not ready_at:
            return {"error": f"no READY line within {args.timeout:.0f} s "
                             f"(exit code {proc.poll()})"}
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray((np.random.RandomState(0).rand(224, 224, 3) * 255)
                        .astype(np.uint8)).save(buf, "JPEG")
        t1 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=args.timeout) as r:
            answer = json.loads(r.read())
        if "label" not in answer:
            return {"error": f"answer without a label: {answer}"}
        return {"ready_s": round(ready_at[0], 3),
                "first_request_s": round(time.perf_counter() - t1, 3)}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ViT-B/16")
    ap.add_argument("--sample_batch", type=int, default=4)
    ap.add_argument("--runs", type=int, default=2,
                    help="fresh-process runs (the best is the figure)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    runs = []
    for i in range(args.runs):
        runs.append(one_run(args))
        print(f"run {i}: {runs[-1]}", file=sys.stderr, flush=True)
    good = [r for r in runs if "ready_s" in r]
    out = {"arch": args.arch, "runs": runs}
    if good:
        out["best_ready_s"] = min(r["ready_s"] for r in good)
        out["best_first_request_s"] = min(r["first_request_s"]
                                          for r in good)
    print(json.dumps(out), flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
