"""Host milliseconds of the four optimiser steps a train step: the
program's dip.step.optimiser spans summed over the window, over its steps,
from the trace (adam.ms_per_step is their device time)."""

from portbench import spans


def read(w):
    d = spans.durations(w.trace, "dip.step.optimiser")
    return float(d.sum()) / w.steps * 1e3 if len(d) and w.steps else None
