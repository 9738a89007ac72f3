"""The share of the traced span in which no device operation ran: 100 x
(1 - the union of the device intervals over the span)."""


def read(run):
    reading = run.get("reading")
    if reading is None or reading.window_s <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)
