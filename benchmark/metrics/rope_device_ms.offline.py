"""Device ms a traced step of the kernels launched inside the program's
`eva.rope` spans (the EVA02 tower's rotary embedding of q and k, in each
layer's forward: the prefix, the adapted window and the clean passes;
RoPE's backward runs on autograd's thread outside the spans and is not
counted). A kernel belongs to the span whose interval holds its launch,
as `harness/spans.py` gives kernels to the stages, over the steps whose
`step` span ends in the traced span. Silent where the program records no
`eva.rope` span."""
import bisect

from benchmark.harness import spans

NAME = "eva.rope"


def read(run):
    ropes = spans.in_span(run, (NAME,))
    steps = spans.steps_in_span(run)
    if not ropes or not steps:
        return None
    ropes.sort(key=lambda s: s.t0)
    starts = [s.t0 for s in ropes]
    launched = spans.launch_times(run["reading"])
    total_us = 0.0
    for e in run["reading"].span_kernels:
        at = launched.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= ropes[i].t1:
            total_us += float(e["dur"])
    return total_us / steps / 1e3
