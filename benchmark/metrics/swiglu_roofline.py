"""The SwiGLU kernels of the EVA02 tower (`csrc/swiglu.cu`, forward and
backward) against their roofline: the least time the traced steps' SwiGLU
launches could take on the card, each its bytes over 3.35 TB/s
(`work/eva02.py::swiglu_calls`: every value read once and written once, at
the true token count), over the time of the SwiGLU kernels launched in the
span. Silent where no SwiGLU kernel ran, or where the configuration's
architecture counts no SwiGLU launch."""
from benchmark.harness import work
from benchmark.harness.device import PEAK_HBM_BYTES_PER_S
from benchmark.harness.manifest import work_counts

KERNELS = ("swiglu_fwd", "swiglu_bwd")


def read(run):
    reading, steps = run.get("reading"), run.get("traced_steps")
    if reading is None or not steps:
        return None
    seconds, launches = reading.kernel_seconds(KERNELS)
    counts = work_counts(run["config"])
    if not launches or not hasattr(counts, "swiglu_calls"):
        return None
    config = run["config"]
    calls = counts.swiglu_calls(config, config["ttl"]["sample_batch"])
    bound = steps * sum(calls) / PEAK_HBM_BYTES_PER_S
    return 100.0 * bound / seconds
