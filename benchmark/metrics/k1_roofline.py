"""K1, the attention forward kernel, against its roofline: the least time
the traced steps' attention forwards could take on the card (each call the
larger of its bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s,
`harness/work.py`: q, k, v read once and o written once, at the true token
count) over the time of the K1 kernels launched in the span. Silent where
no K1 kernel ran."""
from benchmark.harness import work

KERNELS = ("mma_fwd_kernel", "bshd_fwd_tiled_kernel")


def read(run):
    reading, steps = run.get("reading"), run.get("traced_steps")
    if reading is None or not steps:
        return None
    seconds, launches = reading.kernel_seconds(KERNELS)
    if not launches:
        return None
    config = run["config"]
    calls, _ = work.attention_calls(config, config["ttl"]["sample_batch"])
    dtype = work.BYTES[config["ttl"]["compute_dtype"]]
    bound = steps * sum(c.forward_bound_s(dtype) for c in calls)
    return 100.0 * bound / seconds
