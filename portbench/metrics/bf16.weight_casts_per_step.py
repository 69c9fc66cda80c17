"""Per-call casts of a conv weight to the input's dtype a train step (the
bf16 boundary, the remat recompute's included): the program's
dip.bf16.weight_cast spans over the window's steps, from the trace."""

from portbench import spans


def read(w):
    n = spans.count(w.trace, "dip.bf16.weight_cast")
    return n / w.steps if n and w.steps else None
