"""The card's idle share of the traced window: 1 - the union of the device
operations' intervals over the window, in % (train cells)."""


def read(w):
    if w.trace is None or w.kind != "train" or w.trace.window_s <= 0:
        return None
    return (1.0 - w.trace.busy_s / w.trace.window_s) * 100
