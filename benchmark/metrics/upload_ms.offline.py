"""Host ms a batch spends being uploaded: the mean length of the
program's `loader.upload` spans (host draws, pinning and the side-stream
copies' calls, on the loader's thread) that end in the traced span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "loader.upload")
