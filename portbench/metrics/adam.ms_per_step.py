"""Device milliseconds of the optimiser class (multi_tensor / adam
kernels) a train step, from the trace."""


def read(w):
    if w.trace is None or not w.steps:
        return None
    s = w.trace.seconds_of("optimiser")
    return s / w.steps * 1e3 if s > 0 else None
