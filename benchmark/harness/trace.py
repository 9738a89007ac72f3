"""A torch.profiler trace of a few steady steps inside the window, and what
the per-layer metrics read from it.

The traced window is a span the harness opens and closes itself (a
`benchmark.traced_window` annotation on the host). Before the profiler
stops, the card is synchronised, so every launch made inside the span has
run. The profiler stops only when no other thread launches work: device
events of kernels that had run were lost from traces stopped while the
serving thread kept launching (the last tenth of a second of a span, 176
and 627 launches), so a driver whose launches come from the program's own
threads closes the span first and stops the profiler once its load has
drained. The trace is then checked whole before anything is read: the kernel
launches recorded on the host inside the span must have their kernel
events on the device (by correlation id), all but one in a thousand. A
trace that lost device events (one in the program's own tools once lost
half a step's device time, hundreds of kernels) is refused with its reason
and read as no number.

Device time follows the program's profiling arithmetic (its
`utils/profiling.py`): device events are the trace's kernel, memcpy and
memset events; busy time is the union of their intervals inside the span,
so that copies on a side stream that overlap compute count once.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "benchmark.traced_window"
HOST_CATEGORIES = ("cpu_op", "python_function", "user_annotation",
                   "cuda_runtime", "cuda_driver")


class TraceError(RuntimeError):
    """A trace that cannot be read as a number."""


class Tracer:
    """Start and stop a profiler run around a span of the window; the two
    calls are made from one thread."""

    def __init__(self, out_path: str, device):
        """Also runs a profiler once over one small operation, so that the
        profiler's own start-up (CUPTI's) falls in set-up, not in the
        window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.out_path = out_path
        self.device = device
        self.prof = None
        self.mark = None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.mark = torch.profiler.record_function(SPAN)
        self.mark.__enter__()

    def close(self) -> None:
        """Close the span; the profiler records on until `stop`."""
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
            self.mark = None

    def stop(self) -> None:
        import torch

        self.close()
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.prof.export_chrome_trace(self.out_path)
        self.prof = None


def _intervals_union(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Reading:
    """What one trace says, inside its span. Times in seconds."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("name") == SPAN
                 and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if len(spans) != 1:
            raise TraceError(f"{len(spans)} '{SPAN}' spans in the trace")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATEGORIES]
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATEGORIES]
        runtime = [e for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cuda_runtime", "cuda_driver")]
        # launches made inside the span (the call returned before it
        # closed, so the synchronisation after it waits for the kernel), and
        # whether each one's kernel ran
        self.launches = [e for e in runtime
                         if "LaunchKernel" in e.get("name", "")
                         and self.t0 <= float(e["ts"])
                         and float(e["ts"]) + float(e.get("dur", 0))
                         <= self.t1]
        kernel_ids = {e.get("args", {}).get("correlation")
                      for e in self.device if e.get("cat") == "kernel"}
        self.missing = [e for e in self.launches
                        if e.get("args", {}).get("correlation")
                        not in kernel_ids]
        launched = {e.get("args", {}).get("correlation")
                    for e in self.launches}
        # the device work of the launches made inside the span
        self.span_kernels = [e for e in self.device
                             if e.get("cat") == "kernel" and
                             e.get("args", {}).get("correlation") in launched]

    @classmethod
    def load(cls, path: str) -> "Reading":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def check_whole(self) -> None:
        """Refuse a trace in which more than one in a thousand of the
        launches made inside the span have no kernel event (a lost step is
        hundreds)."""
        if not self.launches:
            raise TraceError("no kernel launch recorded inside the span")
        if len(self.missing) > len(self.launches) // 1000:
            where = sorted({(e["name"], round((float(e["ts"]) - self.t0)
                                              / 1e3, 3)) for e in self.missing})
            raise TraceError(
                f"short trace: {len(self.missing)} of {len(self.launches)} "
                f"kernel launches inside the span have no device event "
                f"(name, ms into the span: {where[:8]})")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self):
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                yield e, a, b

    @property
    def busy_s(self) -> float:
        """Seconds of the span in which a device operation ran."""
        return _intervals_union([(a, b) for _, a, b in self._clipped()]) / 1e6

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """Total time and count of the kernels launched inside the span
        whose name contains one of `names`."""
        hits = [e for e in self.span_kernels
                if any(n in e["name"] for n in names)]
        return sum(float(e["dur"]) for e in hits) / 1e6, len(hits)

    def top_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time in the span."""
        time_us: Dict[str, float] = defaultdict(float)
        for e, a, b in self._clipped():
            time_us[e["name"]] += b - a
        rows = sorted(time_us.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], us / 1e6] for name, us in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest stretches of the span with no device operation, each
        named by the host event that overlaps it most."""
        spans = sorted((a, b) for _, a, b in self._clipped())
        gaps, end = [], self.t0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        out = []
        for a, b in gaps:
            best, overlap = "no host event traced", 0.0
            for e in self.host:
                lo = max(a, float(e["ts"]))
                hi = min(b, float(e["ts"]) + float(e["dur"]))
                if hi - lo > overlap and e.get("name") != SPAN:
                    best, overlap = e["name"], hi - lo
            out.append([best[:160], (b - a) / 1e6])
        return out

    def summary(self) -> dict:
        return {"device_events": len(self.device),
                "kernels_launched_in_span": len(self.launches),
                "kernels_missing": len(self.missing),
                "window_s": self.window_s, "busy_s": self.busy_s}


def read(path: str) -> Optional[Reading]:
    """The checked reading of a trace, or None where there is no file."""
    if not os.path.exists(path):
        return None
    reading = Reading.load(path)
    reading.check_whole()
    return reading
