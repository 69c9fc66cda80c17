"""Host milliseconds inside the program's train-step call: the mean
duration of its span dip.step, which ends when the step's last work is
enqueued (no synchronise inside), from the trace."""

from portbench import spans


def read(w):
    d = spans.durations(w.trace, "dip.step")
    return float(d.mean()) * 1e3 if len(d) else None
