"""K2, the attention backward kernels, against their roofline: the least
time the traced steps' attention backwards could take on the card (each
call the larger of its bytes over 3.35 TB/s and its FLOPs over 989
TFLOP/s, `harness/work.py`: q, k, v and dO read once, dq, dk and dv written
once, at the true token count) over the time of the K2 kernels launched in
the span. Silent where no K2 kernel ran."""
from benchmark.harness import work

KERNELS = ("mma_bwd_rows_kernel", "mma_bwd_keys_kernel", "bshd_bwd_kernel",
           "bshd_bwd_tiled_rows_kernel", "bshd_bwd_tiled_keys_kernel")


def read(run):
    reading, steps = run.get("reading"), run.get("traced_steps")
    if reading is None or not steps:
        return None
    seconds, launches = reading.kernel_seconds(KERNELS)
    if not launches:
        return None
    config = run["config"]
    _, calls = work.attention_calls(config, config["ttl"]["sample_batch"])
    dtype = work.BYTES[config["ttl"]["compute_dtype"]]
    bound = steps * sum(c.backward_bound_s(dtype) for c in calls)
    return 100.0 * bound / seconds
