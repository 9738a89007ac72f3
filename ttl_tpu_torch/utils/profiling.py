"""Profiling and tracing utilities.

Counterpart of `ttl_tpu/utils/profiling.py`, on `torch.profiler`:

- `trace(log_dir, device)` wraps a region in a torch.profiler run (CPU
  activity, and CUDA activity when `device` is a card) and writes one
  Chrome-trace JSON into `log_dir` when it exits (viewable in Perfetto or
  chrome://tracing), with the program's spans of every thread;
- `span(name, key)` and `record(name, t0_ns, t1_ns, key)` are the program's
  span recorder, on only while a torch profiler runs in the process;
  `recorded()` is a snapshot of its records and `trace_us(ns)` maps a
  stamp onto a trace's clock;
- `op_stats(trace_dir)` reads the newest trace there into a per-operation
  table of device time; `device_busy_us` and `device_union_us` total it;
- `PhaseTimer` is a named wall-clock accumulator for the eval loop's phases.

The device operations are the trace's kernel, memcpy and memset events.
Busy time is the sum of their durations: where copies on a side stream
overlap compute, the sum counts the overlap twice, and `device_union_us`
gives the time at least one of them ran.

The span recorder. A torch.profiler run records `record_function` ranges
only from the thread that started it, so the work of the loader's, the
batcher's and autograd's threads would be missing from its trace. The
recorder stamps every span itself, from any thread, with the wall clock in
nanoseconds, into a bounded buffer (`CAPACITY` records; the oldest go
first); nothing is written during a run. A record holds the span's name,
its id, the id of the innermost span open on the same thread when it began
(its parent), a `key` (a step or request id; a span without one takes its
parent's), the thread's native id (`threading.get_native_id()`: the `tid`
of the trace's events from the thread that started the profiler; torch
2.11's trace gives another thread's CUDA runtime calls the low 32 bits of
its `threading.get_ident()`, as a positive number), its two stamps and,
for a request, the `step` it rode. On the thread that started the profiler
a span also enters `torch.profiler.record_function(name)`, so the trace
shows it as a `user_annotation` too. Whether a span records is read once,
when it is entered, from the profiler's process-wide flag: with no
profiler running `span` returns one shared no-op context and takes no
stamp. `trace_us` maps a stamp as the trace's exporter does (Kineto's
`ts`: microseconds since `baseTimeNanoseconds`, the wall clock rounded
down to a multiple of 7,889,238 s).
"""
from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# records the span buffer keeps; the oldest go first
CAPACITY = 65536
# the interval Kineto rounds a trace's base time down to, in seconds
TRACE_BASE_S = 7889238


class Span(NamedTuple):
    """One recorded span. Stamps are `time.time_ns()`."""
    name: str
    id: int
    parent: Optional[int]
    key: Optional[int]
    tid: int
    t0_ns: int
    t1_ns: int
    step: Optional[int] = None


_records: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Recording:
    """An entered span while a profiler runs."""

    __slots__ = ("name", "key", "id", "parent", "tid", "t0", "annotation")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        stack = _open_spans()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if self.key is None and parent is not None:
            self.key = parent.key
        self.tid = threading.get_native_id()
        self.annotation = None
        if torch._C._autograd._profiler_enabled():  # the profiling thread
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _open_spans().pop()
        _records.append(Span(self.name, self.id, self.parent, self.key,
                             self.tid, self.t0, t1))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, key: Optional[int] = None):
    """A context manager that records the time its body takes as `name`,
    while a torch profiler runs anywhere in the process; else a shared
    no-op. Enter and leave it on one thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, key)


def record(name: str, t0_ns: int, t1_ns: int, key: Optional[int] = None,
           step: Optional[int] = None) -> None:
    """Record an interval whose ends were stamped (`time.time_ns()`) on
    different threads, such as a request's time in a queue; it has no
    parent. Nothing while no profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        _records.append(Span(name, next(_ids), None, key,
                             threading.get_native_id(), int(t0_ns),
                             int(t1_ns), step))


def recorded() -> List[Span]:
    """A snapshot of the records, oldest first."""
    while True:
        try:
            return list(_records)
        except RuntimeError:  # another thread appended during the copy
            continue


def trace_base_ns(ns: int) -> int:
    """The base time of a trace taken around stamp `ns`: the wall clock
    rounded down to a multiple of TRACE_BASE_S (Kineto's rule)."""
    period = TRACE_BASE_S * 1_000_000_000
    return (int(ns) // period) * period


def trace_us(ns: int) -> float:
    """A `time.time_ns()` stamp on a Chrome trace's clock: microseconds
    since the trace's `baseTimeNanoseconds`."""
    return (int(ns) - trace_base_ns(ns)) / 1000.0


def _export_spans(path: str, spans: List[Span]) -> None:
    """Append `spans` to the Chrome trace at `path`, category
    `program_span`, each on its thread's row."""
    with open(path) as f:
        data = json.load(f)
    pid = os.getpid()
    for s in spans:
        data["traceEvents"].append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": s.tid, "ts": trace_us(s.t0_ns),
            "dur": (s.t1_ns - s.t0_ns) / 1000.0,
            "args": {"id": s.id, "parent": s.parent, "key": s.key,
                     "step": s.step}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda", *, with_stack: bool = False):
    """Profile the region and write `<pid>.<ns>.pt.trace.json` into
    `log_dir`, with the spans every thread recorded meanwhile (category
    `program_span`). On a card the region's work is waited for before the
    trace ends. `with_stack` records the Python frames of each operator
    (the callers of a kernel, at a cost to the traced run). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    first = next(_ids)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _export_spans(path, [s for s in recorded() if s.id > first])


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
