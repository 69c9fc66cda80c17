"""The port's spans (utils/profiling.py::span): record_function ranges at
the train path's layer boundaries while a profiler records, and a shared
no-op otherwise.

What is held here, on the CPU at the tiny configuration:
  * with no profiler, span() returns one shared no-op; every span the
    package opens is named in SPANS;
  * a train step records dip.step with its inputs, forward, D and G phases
    nested in it, and the four optimiser steps beside the phases (with
    grad_accum, a forward per microbatch inside each phase);
  * device_batches records one dip.data.wait per batch, each closed before
    the batch is handed out;
  * a bf16 step records one dip.bf16.weight_cast per conv call whose input
    dtype differs from its weight's (the recompute's included), and a
    remat step one dip.remat.recompute per checkpointed level;
  * torch.export of a bf16 conv, under a profiler, puts no profiler node in
    the graph.
"""

import collections
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from deepinpainting_torch.config import Config
from deepinpainting_torch.data import device_batches
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops.convs import Conv2d, ConvTranspose2d
from deepinpainting_torch.utils import profiling
from deepinpainting_torch.utils.profiling import SPANS, span

from torch_port_helpers import TINY, tiny_batch

PORT = Path(__file__).resolve().parent.parent / "deepinpainting_torch"


def _spans(prof, prefix="dip."):
    """[(name, start_us, end_us)] of the profile's ranges named `prefix`...,
    in start order."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(prefix)]
    return sorted(out, key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _step(cfg, batch_seed=3):
    """A train step object, its state, and a batch."""
    state = TI.create_state(cfg, torch.Generator().manual_seed(0), "cpu")
    return TI.make_train_step(cfg, "cpu"), state, \
        tiny_batch(batch_seed, b=cfg.batch_size)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    first = span("dip.step")
    assert first is span("dip.data.wait") is profiling._NO_SPAN
    assert isinstance(first, contextlib.nullcontext)
    with first, first:            # re-entered, and nested in itself
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("dip.step"), record_function)
        # while torch.compile or torch.export traces: the no-op
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert span("dip.step") is first


def test_every_span_opened_is_named_in_SPANS():
    assert len(set(SPANS)) == len(SPANS)
    assert all(re.fullmatch(r"dip(\.[a-z0-9_]+)+", n) for n in SPANS)
    opened = {m for f in PORT.rglob("*.py")
              for m in re.findall(r"\bspan\(\"([^\"]+)\"\)", f.read_text())}
    assert opened == set(SPANS)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(accum):
    cfg = Config(**TINY, batch_size=2, grad_accum=accum)
    step, state, batch = _step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = _spans(prof)
    (whole,) = _named(spans, "dip.step")
    (inputs,) = _named(spans, "dip.step.inputs")
    (d_phase,) = _named(spans, "dip.step.d_phase")
    (g_phase,) = _named(spans, "dip.step.g_phase")
    forwards = _named(spans, "dip.step.forward")
    optimisers = _named(spans, "dip.step.optimiser")
    assert len(optimisers) == 4
    for s in (inputs, d_phase, g_phase, *forwards, *optimisers):
        assert _inside(s, whole), s
    assert inputs[2] <= d_phase[1] < d_phase[2] <= g_phase[1]
    # the optimiser steps are the phases' siblings: D and F between the
    # phases, G and P after the G phase
    assert [o[1] >= g_phase[2] for o in optimisers] == [False, False,
                                                        True, True]
    assert all(d_phase[2] <= o[1] for o in optimisers)
    if accum == 1:
        (fwd,) = forwards
        assert inputs[2] <= fwd[1] and fwd[2] <= d_phase[1]
    else:
        # each phase runs a forward per microbatch inside it
        assert len(forwards) == 2 * accum
        assert sum(_inside(f, d_phase) for f in forwards) == accum
        assert sum(_inside(f, g_phase) for f in forwards) == accum
    assert not _named(spans, "dip.bf16.weight_cast")
    assert not _named(spans, "dip.remat.recompute")


def test_device_batches_wait_spans_close_before_each_batch():
    n = 4
    items = [{"x": np.full(3, i, np.float32)} for i in range(n)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feed = device_batches(iter(items), "cpu")
        for i in range(n):
            batch = next(feed)
            with record_function("consumer.step"):
                assert float(batch["x"][0]) == i
                torch.ones(64).sum()
    spans = _spans(prof, prefix="")
    waits = _named(spans, "dip.data.wait")
    steps = _named(spans, "consumer.step")
    assert len(waits) == len(steps) == n
    for w, s in zip(waits, steps):
        assert w[2] <= s[1]                     # closed before the step
    assert not any(_inside(s, w) for w in waits for s in steps)
    # the end of the feed is one wait more
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert next(feed, None) is None
    assert len(_named(_spans(prof), "dip.data.wait")) == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_bf16_weight_casts_and_recomputes(depth):
    cfg = Config(**TINY, batch_size=2, dtype="bfloat16", remat=True,
                 remat_depth=depth)
    step, state, batch = _step(cfg)
    calls = collections.Counter()

    def count(mod, args):
        calls[args[0].dtype != mod.weight.dtype] += 1

    for net in (state.G, state.P, state.D, state.F, state.vgg):
        for m in net.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                m.register_forward_pre_hook(count)
    levels = sum(block.remat for net in (state.G, state.P)
                 for block in net.modules() if hasattr(block, "remat"))
    assert levels == 2 * depth
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = _spans(prof)
    casts = _named(spans, "dip.bf16.weight_cast")
    assert calls[True] > 0 and calls[False] > 0     # VGG, D and F stay f32
    assert len(casts) == calls[True]
    assert len(_named(spans, "dip.remat.recompute")) == levels
    (whole,) = _named(spans, "dip.step")
    assert all(_inside(c, whole) for c in casts)


def test_export_of_a_bf16_conv_has_no_profiler_node():
    conv = Conv2d(4, 8, 3, padding=1)
    x = torch.randn(1, 4, 16, 16, dtype=torch.bfloat16)
    for ctx in (contextlib.nullcontext(),
                profile(activities=[ProfilerActivity.CPU])):
        with ctx:
            ep = torch.export.export(conv, (x,))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert not [t for t in targets if "profiler" in t], targets
        assert "aten.to.dtype" in targets            # the cast is traced
        torch.testing.assert_close(ep.module()(x), conv(x))
