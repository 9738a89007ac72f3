"""The time a request waited in the batcher's queue: the mean length of
the program's `serve.queued` records (from `submit`'s stamp to the
batcher's take) that end in the traced span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "serve.queued")
