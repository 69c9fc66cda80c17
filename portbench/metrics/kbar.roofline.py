"""The attention matrix kernel's share of its roofline: the least time of
the traced launches (counts.kbar_seconds) over its device time, in %."""


def read(w):
    if w.trace is None or not w.bounds.get("kbar"):
        return None
    s = w.trace.seconds_of("kbar")
    return w.bounds["kbar"] / s * 100 if s > 0 else None
