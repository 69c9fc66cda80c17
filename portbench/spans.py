"""The program's own spans in a traced window: the record_function ranges
that deepinpainting_torch/utils/profiling.py::span opens while a profiler
records, stamped on the same clock as the device activity.  Host events of
the Trace (trace.py), reduced by name for the per-layer readers; a program
that opens no such span gives an empty reading, and its readers None."""

from __future__ import annotations

import numpy as np


def durations(trace, name: str) -> np.ndarray:
    """Seconds of each host event named `name` (none without a trace)."""
    if trace is None or not trace.host_names:
        return np.zeros(0)
    keep = np.array([n == name for n in trace.host_names])
    return (trace.host_end - trace.host_start)[keep]


def count(trace, name: str) -> int:
    """Host events named `name`."""
    return len(durations(trace, name))
