"""The program's own spans, as the per-layer readers of a traced run read
them.

The program records its spans in-process from every thread while a
profiler runs (`ttl_tpu_torch.utils.profiling`: `recorded()`, each record
stamped with the wall clock in nanoseconds) and maps a stamp onto the
trace's clock with `trace_us`. A reader keeps the records whose end falls
inside the traced span, `[reading.t0, reading.t1]`. A program without the
recorder, or a run that recorded nothing of a name, reads as no number:
nothing here raises for a missing span.

Device time is given to the program's stages by launch: a kernel launched
inside the span (`reading.span_kernels`) is matched to its launch on the
host by correlation id, and belongs to the stage span whose interval holds
the launch's start, whatever thread launched it (the backward's kernels
launch from autograd's worker thread).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional

RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
STAGES = ("step.render", "step.prefix", "step.adapt", "step.classify")


class Interval(NamedTuple):
    """A program span on the trace's clock (microseconds)."""
    name: str
    t0: float
    t1: float
    key: Optional[int]
    tid: int
    step: Optional[int]


def in_span(run: dict, names=None) -> Optional[List[Interval]]:
    """The program's spans (of `names`, or all) whose end falls inside the
    traced span; None without a trace or without the program's recorder."""
    reading = run.get("reading")
    if reading is None:
        return None
    try:
        from ttl_tpu_torch.utils.profiling import recorded, trace_us
    except ImportError:
        return None
    out = []
    for r in recorded():
        if names is not None and r.name not in names:
            continue
        t1 = trace_us(r.t1_ns)
        if reading.t0 <= t1 <= reading.t1:
            out.append(Interval(r.name, trace_us(r.t0_ns), t1, r.key, r.tid,
                                r.step))
    return out


def mean_ms(run: dict, name: str) -> Optional[float]:
    """The mean length in ms of the spans `name` that end in the traced
    span; None where there is none."""
    spans = in_span(run, (name,))
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / len(spans) / 1e3


def _union(intervals) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(a: List[tuple], b: List[tuple]) -> float:
    """The length two sorted unions of intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(reading) -> List[tuple]:
    """The stretches of the traced span with no device operation."""
    busy = _union((a, b) for _, a, b in reading._clipped())
    gaps, end = [], reading.t0
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if reading.t1 > end:
        gaps.append((end, reading.t1))
    return gaps


def idle_share_in(run: dict, name: str) -> Optional[float]:
    """Of the traced span's device-idle time, the share in % that lies
    inside spans `name` (clipped to the traced span)."""
    reading = run.get("reading")
    spans = in_span(run, (name,))
    if not spans:
        return None
    gaps = idle(reading)
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    inside = _union((max(s.t0, reading.t0), min(s.t1, reading.t1))
                    for s in spans)
    return 100.0 * _overlap(gaps, inside) / total


def launch_times(reading) -> Dict[int, float]:
    """Correlation id -> start of the launch call on the host."""
    return {e["args"]["correlation"]: float(e["ts"]) for e in reading.host
            if e.get("cat") in RUNTIME_CATEGORIES
            and "correlation" in e.get("args", {})}


def stage_device_us(run: dict) -> Optional[Dict[str, float]]:
    """Device microseconds of the kernels launched in the traced span,
    by the stage span (`STAGES`) that holds each launch; '' for the
    kernels no stage holds. Only the stages with a span that ends in the
    traced span are keys; None where there is none."""
    reading = run.get("reading")
    stages = in_span(run, STAGES)
    if not stages:
        return None
    stages.sort(key=lambda s: s.t0)
    starts = [s.t0 for s in stages]
    launched = launch_times(reading)
    out = {name: 0.0 for name in {s.name for s in stages} | {""}}
    for e in reading.span_kernels:
        at = launched.get(e.get("args", {}).get("correlation"))
        holder = ""
        if at is not None:
            # the latest stage begun before the launch that is still open
            for s in reversed(stages[:bisect.bisect_right(starts, at)]):
                if at <= s.t1:
                    holder = s.name
                    break
        out[holder] += float(e["dur"])
    return out


def steps_in_span(run: dict) -> int:
    """The fused steps whose `step` span ends in the traced span."""
    return len(in_span(run, ("step",)) or [])


def stage_ms_per_step(run: dict, stage: str) -> Optional[float]:
    """Device ms per traced step of the kernels launched inside `stage`."""
    by_stage, steps = stage_device_us(run), steps_in_span(run)
    if by_stage is None or not steps or stage not in by_stage:
        return None
    return by_stage[stage] / steps / 1e3
