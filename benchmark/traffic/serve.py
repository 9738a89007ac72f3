"""Serving traffic: independent clients of the HTTP endpoint, open loop.

The program's entry is `ttl_tpu_torch.serve.serve` over a `TTLPredictor`,
as `python -m ttl_tpu_torch.serve` runs it, started in this process on a
free local port with the mix's gathering delay and queue bound. A load
generator in a process of its own (`loadgen.py`) posts one JPEG per
request to /predict at the arrival times of a Poisson process of the mix's
rate: independent exponential gaps, drawn from the mix's own arrival seed,
so that every run offers the same arrivals; the run's seed makes the
JPEGs and picks the one each request posts. Before the window the
generator posts warm-up waves (set-up).
Each request is timed on the generator from its scheduled send time to
its response; a shed (503), refused or failed request counts as failed.
The server's own counters (GET /metrics) are read before and after.

With a trace, the traced span is the window's last `trace.span_s`
seconds; the profiler stops once every response is in, when the server's
thread has stopped launching.
"""
from __future__ import annotations

import http.client
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

from benchmark.harness import images as jpegs
from benchmark.harness.manifest import BENCH
from benchmark.harness.program import classnames, program_config

HOST = "127.0.0.1"


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def get_json(port: int, path: str, timeout: float = 10.0) -> dict:
    conn = http.client.HTTPConnection(HOST, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"GET {path}: {resp.status}")
        return json.loads(body) if path != "/healthz" else {}
    finally:
        conn.close()


def wait_ready(port: int, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while True:
        try:
            get_json(port, "/healthz", 2.0)
            return
        except (OSError, http.client.HTTPException, RuntimeError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def schedule(seed: int, arrivals: dict, rate: float, seconds: float,
             files) -> list:
    """[(send time s, file)]: the arrivals of a Poisson process of `rate`
    over `seconds` (independent exponential gaps, from the mix's
    `arrivals["seed"]`, the same for every run), each posting a file the
    run's seed picks."""
    if arrivals["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arrivals['process']!r}")
    gen = np.random.default_rng([arrivals["seed"], 0xA771])
    gaps = gen.exponential(1.0 / rate, int(rate * seconds * 1.5) + 64)
    at = np.concatenate([[0.0], np.cumsum(gaps)])
    at = at[at < seconds]
    picks = np.random.default_rng([seed, 0x5E4E]).integers(
        0, len(files), len(at))
    return [(float(t), files[int(k)]) for t, k in zip(at, picks)]


def content_index(path: str) -> int:
    """The server's draw index of an image: a hash of its decoded pixels."""
    return zlib.crc32(np.ascontiguousarray(jpegs.decode(path)).tobytes()) \
        & 0x7FFFFFFF


def quantile(values, q: float) -> float:
    """The q-th quantile of `values`, exclusive method (Python's
    statistics.quantiles); infinite where it falls on a failed request."""
    vals = sorted(values)
    if len(vals) < 2:
        return vals[0]
    pos = q * (len(vals) + 1) - 1
    lo = min(max(int(math.floor(pos)), 0), len(vals) - 1)
    hi = min(lo + 1, len(vals) - 1)
    frac = min(max(pos - lo, 0.0), 1.0)
    if math.isinf(vals[hi]) or math.isinf(vals[lo]):
        return math.inf
    return vals[lo] + (vals[hi] - vals[lo]) * frac


def run(ctx: dict) -> dict:
    from ttl_tpu_torch.serve import TTLPredictor, serve

    cell, seed = ctx["cell"], ctx["seed"]
    traffic = cell.traffic
    marks = {"harness_ready": time.time()}
    files = jpegs.write_set(seed, traffic["distinct_images"],
                            *traffic["long_side_px"], ctx["workdir"])
    marks["images_written"] = time.time()
    cfg = program_config(cell, seed, ctx.get("control"))
    names = classnames(traffic)
    predictor = TTLPredictor(names, cfg, device=ctx["device"])
    marks["predictor_ready"] = time.time()
    port = free_port()
    threading.Thread(target=serve, args=(predictor, HOST, port), daemon=True,
                     kwargs={"max_delay_ms": traffic["max_delay_ms"],
                             "max_queue": traffic["max_queue"]}).start()
    wait_ready(port)
    marks["server_ready"] = time.time()
    rate = ctx.get("rate") or traffic["rate_per_s"]
    plan = {"host": HOST, "port": port, "timeout_s": traffic["timeout_s"],
            "senders": traffic["senders"], "files": files,
            "warmup": [[files[(w * 8 + i) % len(files)]
                        for i in range(cfg.sample_batch)]
                       for w in range(traffic["warmup_waves"])],
            "schedule": schedule(seed, traffic["arrivals"], rate,
                                 ctx["seconds"], files)}
    plan_path = os.path.join(ctx["workdir"], "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    trace_path = tracer = None
    if ctx["trace"]:
        from benchmark.harness.trace import Tracer
        trace_path = os.path.join(ctx["workdir"], "trace.json")
        tracer = Tracer(trace_path, ctx["device"])
    gen = subprocess.Popen(
        [sys.executable, str(BENCH / "traffic" / "loadgen.py"), plan_path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        gen.stdin.write("warm\n")
        gen.stdin.flush()
        if gen.stdout.readline().strip() != "warmed":
            raise RuntimeError("the load generator's warm-up failed")
        marks["warmed"] = time.time()
        before = get_json(port, "/metrics")
        t_go = time.time()
        gen.stdin.write("go\n")
        gen.stdin.flush()
        if tracer is not None:
            t_end = t_go + ctx["seconds"]
            time.sleep(max(0.0, t_end - cell.check["trace"]["span_s"]
                           - time.time()))
            tracer.start()
            time.sleep(max(0.0, t_end - time.time()))
            tracer.close()
        out_text, _ = gen.communicate(
            timeout=ctx["seconds"] + traffic["timeout_s"] + 60)
        if tracer is not None:
            tracer.stop()
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    if gen.returncode != 0:
        raise RuntimeError(f"the load generator exited {gen.returncode}")
    after = get_json(port, "/metrics")
    reqs = json.loads(out_text.strip().splitlines()[-1])["requests"]
    ok = [r for r in reqs if r["status"] == 200]
    lat_ms = [(r["done"] - r["at"]) * 1e3 if r["status"] == 200
              else math.inf for r in reqs]
    p95, p50 = quantile(lat_ms, 0.95), quantile(lat_ms, 0.50)
    if math.isinf(p95):
        raise RuntimeError(f"{len(reqs) - len(ok)} of {len(reqs)} requests "
                           "failed: the 95th percentile is a failed one")
    crc = {path: content_index(path) for path in files}
    answers = [{"key": i,
                "topk": [(e["label"], float(e["prob"]))
                         for e in r["answer"]["topk"]],
                "zero_shot_label": r["answer"]["zero_shot_label"]}
               for i, r in enumerate(reqs) if r["status"] == 200]
    counters = {k: after[k] - before[k] for k in
                ("served_total", "batches_total", "shed_total",
                 "failed_total", "accepted_total")}
    late = [r["sent"] - r["at"] for r in reqs]
    out = {
        "setup_s": t_go - ctx["t_start"],
        "end_to_end": {"latency_p95_ms": p95, "latency_p50_ms": p50},
        "attempted": len(reqs), "failed": len(reqs) - len(ok),
        "answers": answers,
        "item": lambda key: (reqs[key]["file"], crc[reqs[key]["file"]]),
        "classnames": names,
        "canvas": cfg.canvas or 512, "counters": counters,
        "info": {"setup_marks_s": {k: v - ctx["t_start"]
                                   for k, v in marks.items()},
                 "requests": len(reqs), "rate_per_s": rate,
                 "statuses": {str(s): sum(r["status"] == s for r in reqs)
                              for s in sorted({r["status"] for r in reqs})},
                 "generator_late_ms_max": max(late) * 1e3,
                 "generator_late_ms_median": statistics.median(late) * 1e3,
                 "counters": counters},
    }
    if trace_path is not None:
        out["trace_path"] = trace_path
    return out
