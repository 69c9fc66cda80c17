"""Host milliseconds a step waits for its batch: the benchmark's span
around next() on data/iterator.py::device_batches, a mean over the
window's steps."""


def read(w):
    waits = w.spans.get("data.wait")
    return sum(waits) / len(waits) * 1e3 if waits else None
