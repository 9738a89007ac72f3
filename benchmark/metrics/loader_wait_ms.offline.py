"""The time a traced step's dispatch waited on the loader: the mean length
of the program's `predict.loader_wait` spans (the loop blocked on the
loader's next batch) that end in the traced span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "predict.loader_wait")
