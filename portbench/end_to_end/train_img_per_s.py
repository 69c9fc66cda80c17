"""Training images completed over the whole window: every step's images
over all of its time, the window ending in a synchronise."""


def read(w):
    if w.kind != "train" or w.seconds <= 0:
        return None
    return w.images / w.seconds
