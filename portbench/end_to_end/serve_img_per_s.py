"""Requests answered over the whole window: from the first request sent
to the last answer."""


def read(w):
    if w.kind != "serve" or w.seconds <= 0 or not w.images:
        return None
    return w.images / w.seconds
