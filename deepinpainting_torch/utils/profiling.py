"""Tracing (counterpart of deepinpainting_tpu/utils/profiling.py).

`trace(log_dir)` wraps a region in torch.profiler (host and, where a card
is present, device activity) and writes a Chrome trace to
`{log_dir}/trace.json`.

`span(name)` marks a layer boundary of the program as a
`torch.profiler.record_function` range, which the profiler stamps on the
same clock as the device activity it records, so a trace names what the
host was doing at each point of the device's timeline.  The profiler is
the one switch: with none recording the calling thread, `span` returns a
shared no-op and costs one check.  Every name is in `SPANS`:

  dip.step              one train step, the whole call
  dip.step.inputs       the batch to NCHW tensors and masks on the device
  dip.step.forward      VGG features, the two-stage forward, the fake's
                        relu3_3 (under grad_accum: a microbatch's, inside
                        its phase)
  dip.step.d_phase      the D/F losses and their gradients
  dip.step.g_phase      the G/P losses and their gradients
  dip.step.optimiser    one network's optimiser step (four a step)
  dip.data.wait         the consumer's wait on device_batches' prefetch queue
  dip.bf16.weight_cast  a conv's per-call cast of its weight to the input's
                        dtype
  dip.remat.recompute   a checkpointed U-Net level's forward run again in
                        the backward
  dip.hand.direct2d     a launch of the hand-written f32 convolution
                        (ops/convs.py): a kernel-4 Conv2d's forward or a
                        ConvTranspose2d's input gradient
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

SPANS = ("dip.step", "dip.step.inputs", "dip.step.forward",
         "dip.step.d_phase", "dip.step.g_phase", "dip.step.optimiser",
         "dip.data.wait", "dip.bf16.weight_cast", "dip.remat.recompute",
         "dip.hand.direct2d")

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A record_function range named `name` (one of SPANS) while a profiler
    records this thread; otherwise, and while torch.compile or
    torch.export traces, the shared no-op context."""
    if not torch.autograd._profiler_enabled() \
            or torch.compiler.is_compiling():
        return _NO_SPAN
    return torch.profiler.record_function(name)
