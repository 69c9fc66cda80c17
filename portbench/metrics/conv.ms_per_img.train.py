"""Device milliseconds of the convolution class an image trained on,
from the trace."""


def read(w):
    if w.trace is None or w.kind != "train" or not w.images:
        return None
    s = w.trace.seconds_of("convolution")
    return s / w.images * 1e3 if s > 0 else None
