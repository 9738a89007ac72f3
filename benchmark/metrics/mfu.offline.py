"""The whole step's share of the card's bf16 peak: the model FLOPs of the
images whose lines were written in the traced span (`harness/work.py`,
the adaptation and the zero-shot aux pass) over the
span's length times 989 TFLOP/s (H100 SXM, dense bf16, at 700 W; the run
prints the card's power limit)."""
from benchmark.harness import work
from benchmark.harness.device import PEAK_BF16_FLOPS


def read(run):
    reading, images = run.get("reading"), run.get("traced_images")
    if reading is None or not images:
        return None
    flops = images * work.image_flops(run["config"])
    return 100.0 * flops / (reading.window_s * PEAK_BF16_FLOPS)
