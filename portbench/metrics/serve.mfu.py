"""The two-stage inference's share of the card's peak: the least time of an
image's model operations (counts.py, each precision against its own
peak) times the images a second of the traced window, in %."""

from portbench import counts


def read(w):
    if w.kind != "serve" or not w.images or w.seconds <= 0:
        return None
    return counts.least_seconds(w.flops) * w.images / w.seconds * 100
