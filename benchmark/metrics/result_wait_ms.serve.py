"""The batcher's wait for a step's results: the mean length of the
program's `serve.collect` spans (the fetch of the logits to the host,
which waits for the step) that end in the traced span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "serve.collect")
