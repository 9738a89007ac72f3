"""The predictor's upload a step: the mean length of the program's
`serve.upload` spans (the canvases, sizes and draws copied to the card
from pageable memory on the current stream) that end in the traced
span."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "serve.upload")
