"""The batcher's gather a step: the mean length of the program's
`serve.gather` spans (first request taken to the group closed) that end in
the traced span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "serve.gather")
