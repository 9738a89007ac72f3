"""Of the traced span's device-idle time (no kernel, copy or memset
running), the share that lies inside the program's `serve.upload` spans:
how much of the card's idling waits on the serving upload."""
from benchmark.harness import spans


def read(run):
    return spans.idle_share_in(run, "serve.upload")
