"""The layernorm kernels' RMS launches (AIMv2's RMSNorm, forward and dx
backward: `rms_norm_fwd_kernel`, `rms_norm_bwd_kernel` in
`csrc/layer_norm.cu`) against their roofline: the least time the traced
steps' RMS launches could take on the card, each its bytes over 3.35 TB/s
(`work/lit_aimv2.py::rms_norm_calls`: every value read once and written once,
at the true token count), over the time of those kernels launched in the
span. Silent where no such kernel ran, or where the configuration's
architecture counts no RMS launch."""
from benchmark.harness.device import PEAK_HBM_BYTES_PER_S
from benchmark.harness.manifest import work_counts

KERNELS = ("rms_norm_fwd_kernel", "rms_norm_bwd_kernel")


def read(run):
    reading, steps = run.get("reading"), run.get("traced_steps")
    if reading is None or not steps:
        return None
    seconds, launches = reading.kernel_seconds(KERNELS)
    counts = work_counts(run["config"])
    if not launches or not hasattr(counts, "rms_norm_calls"):
        return None
    config = run["config"]
    calls = counts.rms_norm_calls(config, config["ttl"]["sample_batch"])
    bound = steps * sum(calls) / PEAK_HBM_BYTES_PER_S
    return 100.0 * bound / seconds
