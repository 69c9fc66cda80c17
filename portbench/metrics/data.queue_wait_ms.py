"""Host milliseconds the consumer waits on the prefetch queue of
data/iterator.py::device_batches: the mean duration of the program's span
dip.data.wait, from the trace (the in-program twin of data.wait_ms, which
the benchmark times around next())."""

from portbench import spans


def read(w):
    d = spans.durations(w.trace, "dip.data.wait")
    return float(d.mean()) * 1e3 if len(d) else None
