"""Device milliseconds an image: the time in the traced span in which a
device operation (kernel, copy, memset) ran, over the images whose lines
were written in it."""


def read(run):
    reading, images = run.get("reading"), run.get("traced_images")
    if reading is None or not images:
        return None
    return reading.busy_s * 1e3 / images
