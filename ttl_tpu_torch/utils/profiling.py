"""Profiling and tracing utilities.

Counterpart of `ttl_tpu/utils/profiling.py`, on `torch.profiler`:

- `trace(log_dir, device)` wraps a region in a torch.profiler run (CPU
  activity, and CUDA activity when `device` is a card) and writes one
  Chrome-trace JSON into `log_dir` when it exits (viewable in Perfetto or
  chrome://tracing);
- `op_stats(trace_dir)` reads the newest trace there into a per-operation
  table of device time; `device_busy_us` and `device_union_us` total it;
- `PhaseTimer` is a named wall-clock accumulator for the eval loop's phases.

The device operations are the trace's kernel, memcpy and memset events.
Busy time is the sum of their durations: where copies on a side stream
overlap compute, the sum counts the overlap twice, and `device_union_us`
gives the time at least one of them ran.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, device="cuda", *, with_stack: bool = False):
    """Profile the region and write `<pid>.<ns>.pt.trace.json` into
    `log_dir`. On a card the region's work is waited for before the trace
    ends. `with_stack` records the Python frames of each operator (the
    callers of a kernel, at a cost to the traced run). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _device_events(trace_dir: str) -> Optional[List[dict]]:
    """The device events of the newest trace in trace_dir, or None when
    there is none."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if not files:
        return None
    newest = max(files, key=lambda f: (os.path.getmtime(f), f))
    with open(newest) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def op_stats(trace_dir: str, top: int = 15) -> List[Dict]:
    """The newest trace's device operations by total self time, the `top`
    first: a dict each with `operation` (the kernel's name), `type` (the
    event's category), `self_time_us`, `fraction` (of every device
    operation's time), `bound_by` and `occurrences`. `bound_by` is None:
    the trace has no roofline column, unlike the xprof table the JAX
    package reads. [] when there is no trace. Prints nothing."""
    events = _device_events(trace_dir)
    if not events:
        return []
    time_us: Dict[tuple, float] = defaultdict(float)
    count: Dict[tuple, int] = defaultdict(int)
    for e in events:
        key = (e["name"], e["cat"])
        time_us[key] += float(e["dur"])
        count[key] += 1
    total = sum(time_us.values())
    rows = sorted(time_us, key=lambda k: -time_us[k])[:top]
    return [{"operation": name, "type": cat, "self_time_us": time_us[name,
                                                                     cat],
             "fraction": time_us[name, cat] / total if total else 0.0,
             "bound_by": None, "occurrences": count[name, cat]}
            for name, cat in rows]


def device_busy_us(trace_dir: str) -> Optional[float]:
    """The UNTRUNCATED sum of every device operation's time (us) in the
    newest trace, or None when there is no trace. Busy figures must use it,
    not a sum over op_stats' top rows."""
    events = _device_events(trace_dir)
    return None if events is None else sum(float(e["dur"]) for e in events)


def device_union_us(trace_dir: str) -> Optional[float]:
    """The time (us) in which at least one device operation ran, over every
    stream: the busy sum less the overlaps. None when there is no trace."""
    events = _device_events(trace_dir)
    if events is None:
        return None
    total, end = 0.0, float("-inf")
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in events):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


class PhaseTimer:
    """Named wall-clock accumulator: with timer.phase("adapt"): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {self.totals[k]:.3f}s/{self.counts[k]}"
            for k in sorted(self.totals))
