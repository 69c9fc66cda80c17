"""Tracing and step timing (counterpart of
deepinpainting_tpu/utils/profiling.py).

`trace(log_dir)` wraps a region in torch.profiler (host and, where a card
is present, device activity) and writes a Chrome trace to
`{log_dir}/trace.json`; `StepTimer` gives per-step wall times that end
with the device's work, not with its dispatch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler over the block; a no-op when log_dir is falsy."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock per-step timer; `stop(block_on)` first waits for the
    device that `block_on` (a tensor) lives on, so the interval covers its
    work."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, block_on: Optional[torch.Tensor] = None) -> float:
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, skip_first: int = 1) -> dict:
        xs = self.times[skip_first:] or self.times
        return {"mean_s": sum(xs) / len(xs), "min_s": min(xs),
                "max_s": max(xs), "steps": len(xs)}
