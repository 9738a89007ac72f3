"""Requests a device step carried, over the window: the server's own
counters (GET /metrics), served_total over batches_total, read before and
after the window. The batch is at most the configuration's sample_batch;
every step costs a full batch, so a low fill is paid latency."""


def read(run):
    counters = run.get("counters")
    if not counters or not counters.get("batches_total"):
        return None
    return counters["served_total"] / counters["batches_total"]
