"""The device trace of a traced run, reduced to what the per-layer readers
and the breakdown take.

`capture()` wraps the traced window in torch.profiler (host and device
activity) and keeps the raw events: every device operation (kernels,
copies, fills) as a named interval, and every host event (PyTorch ops,
CUDA runtime calls, the benchmark's own spans) as another.

  * busy: the length of the union of the device intervals, so that
    operations that overlap (an upload on a side stream under a kernel)
    count once; idle = 1 - busy / window.
  * classes: device time by kernel class, by name (the class table of
    chip_smoke.py's profile_calls).
  * breakdown: the device operations that took most time, and the longest
    idle gaps, each named by the innermost host event in progress at the
    gap's middle.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

CLASSES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("scan", ("scan_stream",)),
    ("kbar", ("kbar_build",)),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit",
                     "winograd", "fft", "precomputed", "nchwtonhwc",
                     "nhwctonchw")),
    ("matmul", ("gemm", "gemv")),
    ("optimiser", ("multi_tensor", "adam")),
    ("collective", ("nccl",)),
    ("copy", ("memcpy", "memset")),
)
OTHER = "elementwise/other"
LONGEST_GAPS = 256          # gaps named for the breakdown
TOP = 10


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return OTHER


def union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    """Length of the union of [start, end) intervals (any units in, the
    same units out)."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # a new block starts where an interval begins after all before it end
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    block_end = np.append(reach[idx[1:] - 1], reach[-1])
    return float((block_end - s[idx]).sum())


def gaps(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float
         ) -> Tuple[np.ndarray, np.ndarray]:
    """The idle intervals of [lo, hi) outside every [start, end)."""
    if len(starts) == 0:
        return np.array([lo]), np.array([hi])
    order = np.argsort(starts, kind="stable")
    s = np.clip(starts[order], lo, hi)
    e = np.clip(np.maximum.accumulate(ends[order]), lo, hi)
    g_lo = np.concatenate([[lo], e])
    g_hi = np.concatenate([s, [hi]])
    keep = g_hi > g_lo
    return g_lo[keep], g_hi[keep]


@dataclass
class Trace:
    """Events of the traced window, in seconds on the host's clock."""
    window_s: float
    dev_names: List[str] = field(default_factory=list)
    dev_start: np.ndarray = field(default_factory=lambda: np.zeros(0))
    dev_end: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_names: List[str] = field(default_factory=list)
    host_start: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_end: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def busy_s(self) -> float:
        return union_seconds(self.dev_start, self.dev_end)

    def seconds_by_class(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, d in zip(self.dev_names, self.dev_end - self.dev_start):
            cls = classify(name)
            out[cls] = out.get(cls, 0.0) + float(d)
        return out

    def seconds_of(self, cls: str) -> float:
        return self.seconds_by_class().get(cls, 0.0)

    def breakdown(self) -> Dict[str, List[list]]:
        """{'device_ops': [[name, s]], 'idle_gaps': [[host event, s]]},
        each the TOP largest."""
        ops: Dict[str, float] = {}
        for name, d in zip(self.dev_names, self.dev_end - self.dev_start):
            key = name[:120]
            ops[key] = ops.get(key, 0.0) + float(d)
        starts = np.concatenate([self.dev_start, self.host_start])
        ends = np.concatenate([self.dev_end, self.host_end])
        lo = float(starts.min()) if len(starts) else 0.0
        hi = float(ends.max()) if len(ends) else 0.0
        g_lo, g_hi = gaps(self.dev_start, self.dev_end, lo, hi)
        longest = np.argsort(g_hi - g_lo)[::-1][:LONGEST_GAPS]
        idle: Dict[str, float] = {}
        for i in longest:
            mid = 0.5 * (g_lo[i] + g_hi[i])
            inside = np.flatnonzero((self.host_start <= mid)
                                    & (self.host_end >= mid))
            if len(inside):
                k = inside[np.argmin(self.host_end[inside]
                                     - self.host_start[inside])]
                name = self.host_names[k][:120]
            else:
                name = "no host event"
            idle[name] = idle.get(name, 0.0) + float(g_hi[i] - g_lo[i])
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def from_events(events, window_s: float) -> Trace:
    """A Trace of profiler events (objects with name(), device_type(),
    start_ns(), duration_ns()); times in seconds from the first event.  A
    host span mirrored onto the device's timeline (a device event named as
    a host event is, such as the benchmark's own spans) is no device
    operation and is left out."""
    from torch.autograd import DeviceType
    rows = [(ev.device_type() == DeviceType.CUDA, ev.name(), ev.start_ns(),
             ev.duration_ns()) for ev in events]
    base = min((r[2] for r in rows), default=0)
    host = [r for r in rows if not r[0]]
    host_names = {r[1] for r in host}
    dev = [r for r in rows if r[0] and r[1] not in host_names]

    def arrays(part):
        start = np.array([(r[2] - base) * 1e-9 for r in part])
        return ([r[1] for r in part], start,
                start + np.array([r[3] * 1e-9 for r in part]))

    return Trace(window_s, *arrays(dev), *arrays(host))


class Capture:
    """Result holder of capture(): .trace once the block has ended."""
    trace: Trace


@contextlib.contextmanager
def capture(sync):
    """Profile the block; `sync` waits for the device.  The window runs
    from the first synchronisation inside the profiler to the last."""
    from torch.profiler import ProfilerActivity, profile
    out = Capture()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        yield out
        sync()
        window = time.perf_counter() - t0
    out.trace = from_events(prof.profiler.kineto_results.events(), window)

