"""The scan kernel's share of its roofline in serving: the least
time of the traced launches on their own inputs (counts.scan_seconds of
each request answered) over the kernel's device time, in %."""


def read(w):
    if w.trace is None or w.kind != "serve" or not w.bounds.get("scan"):
        return None
    s = w.trace.seconds_of("scan")
    return w.bounds["scan"] / s * 100 if s > 0 else None
