"""Offline traffic: batch prediction over a directory of JPEGs.

The program's entry is `ttl_tpu_torch.predict.predict_directory`, as
`python -m ttl_tpu_torch.predict DIR` runs it: its loader decodes every
image, its fused step adapts each one, and it writes one JSON line per
image. The harness hands it a dataset of the run's JPEGs, cycled by index
(each index has its own view draws), long enough to outlast any window,
and a sink for its lines. The sink stamps each batch's lines as they are
written. The window opens when the first batch's lines are written (the
steps before it load the model, build the kernels and fill the pipeline:
set-up) and closes at the first batch written `seconds` later; the sink
then ends the call by raising `WindowClosed`. images_per_s is every line
written after the first batch, up to and including the closing one, over
the time between the two.

With a trace, the sink opens the traced span at the first batch written
`trace.after_s` into the window and closes it at the first batch written
`trace.span_s` later; the steps launched in between are the traced steps.
The program's counters (`harness/counters.py`) are read as the span opens
and as it closes: `counters` is how much each grew over the traced steps.
"""
from __future__ import annotations

import json
import os
import time

import torch

from benchmark.harness import counters
from benchmark.harness import images as jpegs
from benchmark.harness.program import classnames, program_config


class WindowClosed(Exception):
    """Raised by the sink when the window has closed."""


class CycledImages:
    """`n` dataset entries over a few files: entry i is file i % len(files),
    label 0, as the program's directory dataset gives them. It has no
    `paths`, so each line names its entry by index."""

    def __init__(self, files, n: int):
        self.files, self.n = list(files), n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.files[i % len(self.files)], 0


class Sink:
    """The file the program writes its lines to."""

    def __init__(self, seconds: float, batch: int, tracer=None,
                 trace_after_s: float = 0.0, trace_span_s: float = 0.0):
        self.seconds, self.batch = seconds, batch
        self.tracer = tracer
        self.trace_after_s, self.trace_span_s = trace_after_s, trace_span_s
        self.lines = []           # (time, answer) of every line written
        self.batch_times = []     # time each batch's last line was written
        self.t0 = self.t_end = None
        self.trace_batches = None     # (first, last) batch of the span
        self.trace_counters = []      # the program's counters at each end
        self._trace_open_at = None

    def write(self, text: str) -> int:
        now = time.perf_counter()
        for line in text.splitlines():
            if not line.strip():
                continue
            ans = json.loads(line)
            self.lines.append((now, ans))
            if int(ans["path"]) % self.batch == self.batch - 1:
                self._batch_written(now)
        return len(text)

    def flush(self) -> None:
        pass

    def _batch_written(self, now: float) -> None:
        k = len(self.batch_times)
        self.batch_times.append(now)
        if self.t0 is None:
            self.t0 = now
            return
        if self.tracer is not None:
            if self._trace_open_at is None and \
                    now - self.t0 >= self.trace_after_s:
                self.tracer.start()
                self._trace_open_at = (k, time.perf_counter())
                self.trace_counters.append(counters.read())
            elif self.trace_batches is None and self._trace_open_at \
                    and now - self._trace_open_at[1] >= self.trace_span_s \
                    and k - self._trace_open_at[0] >= 2:
                self.trace_counters.append(counters.read())
                self.tracer.stop()
                self.trace_batches = (self._trace_open_at[0], k)
        if now - self.t0 >= self.seconds and (
                self.tracer is None or self.trace_batches is not None):
            self.t_end = now
            raise WindowClosed


def run(ctx: dict) -> dict:
    from ttl_tpu_torch.predict import predict_directory

    cell, seed = ctx["cell"], ctx["seed"]
    traffic = cell.traffic
    marks = {"harness_ready": time.time()}
    files = jpegs.write_set(seed, traffic["distinct_images"],
                            *traffic["long_side_px"], ctx["workdir"])
    marks["images_written"] = time.time()
    cfg = program_config(cell, seed, ctx.get("control"))
    names = classnames(traffic)
    tracer = None
    if ctx["trace"]:
        from benchmark.harness.trace import Tracer
        tracer = Tracer(os.path.join(ctx["workdir"], "trace.json"),
                        ctx["device"])
    sink = Sink(ctx["seconds"], cfg.sample_batch, tracer,
                cell.check["trace"]["after_s"], cell.check["trace"]["span_s"])
    try:
        predict_directory(cfg, names, device=ctx["device"],
                          dataset=CycledImages(files, 1 << 22),
                          topk=traffic["topk"], out=sink)
    except WindowClosed:
        pass
    if sink.t_end is None:
        raise RuntimeError("the program's run ended before the window "
                           "closed")
    if ctx["device"].type == "cuda":
        torch.cuda.synchronize(ctx["device"])
    t0, t_end = sink.t0, sink.t_end
    window = [ans for t, ans in sink.lines if t0 < t <= t_end]
    marks["first_batch_written"] = time.time() - (time.perf_counter() - t0)
    setup_s = marks["first_batch_written"] - ctx["t_start"]
    answers = [{"key": int(a["path"]),
                "topk": [(e["label"], float(e["prob"])) for e in a["topk"]],
                "zero_shot_label": a["zero_shot_label"]} for a in window]
    n_files = len(files)
    out = {
        "setup_s": setup_s,
        "end_to_end": {"images_per_s": len(window) / (t_end - t0)},
        "attempted": len(window), "failed": 0, "answers": answers,
        "item": lambda key: (files[key % n_files], key),
        "classnames": names,
        "canvas": cfg.canvas or 512,
        "info": {"setup_marks_s": {k: v - ctx["t_start"]
                                   for k, v in marks.items()},
                 "window_s": t_end - t0,
                 "images_in_window": len(window),
                 "batches_in_window": len(window) // cfg.sample_batch,
                 "batch_s": [t - t0 for t in sink.batch_times
                             if t0 <= t <= t_end],
                 "distinct_files": n_files},
    }
    if tracer is not None:
        first, last = sink.trace_batches
        out["trace_path"] = tracer.out_path
        out["traced_steps"] = last - first
        out["traced_images"] = (last - first) * cfg.sample_batch
        out["counters"] = counters.grown(*sink.trace_counters)
    return out
