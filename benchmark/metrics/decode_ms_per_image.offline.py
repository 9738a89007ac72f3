"""Loader decode ms an image: the program's `loader.decode` spans (native
or PIL decode and the canvases, on the loader's thread) that end in the
traced span, over the images of those batches (the configuration's
sample_batch each)."""
from benchmark.harness import spans


def read(run):
    decoded = spans.in_span(run, ("loader.decode",))
    if not decoded:
        return None
    batch = run["config"]["ttl"]["sample_batch"]
    return sum(s.t1 - s.t0 for s in decoded) / (len(decoded) * batch) / 1e3
