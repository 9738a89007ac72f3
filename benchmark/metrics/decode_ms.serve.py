"""The batcher's decode a step: the mean length of the program's
`serve.decode` spans (the group's PIL decode, one request after another)
that end in the traced span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "serve.decode")
