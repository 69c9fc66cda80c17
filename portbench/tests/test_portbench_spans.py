"""The readers of the program's own spans (spans.py and the metrics that
use it): each on a synthetic Trace, None where the program opens no span;
the span names kept out of the kernel classes; and a traced run on the CPU
whose line carries all four."""

from types import SimpleNamespace

import numpy as np
import pytest

from conftest import TINY, tiny_cell
from portbench import harness, spans
from portbench import trace as T

NEW = ("train.host_ms_per_step", "adam.host_ms_per_step",
       "data.queue_wait_ms", "bf16.weight_casts_per_step")


def _trace(host):
    """A Trace of one kernel and the host events [(name, start, end)]."""
    names = [h[0] for h in host]
    return T.Trace(window_s=1.0, dev_names=["k"], dev_start=np.array([0.0]),
                   dev_end=np.array([0.5]), host_names=names,
                   host_start=np.array([h[1] for h in host]),
                   host_end=np.array([h[2] for h in host]))


def _window(trace, steps=2):
    return harness.Window("train", 1.0, steps=steps, images=8 * steps,
                          trace=trace)


def _two_steps():
    host = [("portbench.step", 0.0, 1.0), ("aten::conv2d", 0.1, 0.2)]
    for k, (lo, hi) in enumerate(((0.0, 0.1), (0.5, 0.7))):
        host += [("dip.data.wait", lo - 0.002 * (k + 1), lo),
                 ("dip.step", lo, hi)]
        host += [("dip.step.optimiser", lo + 0.01 * j, lo + 0.01 * j + 0.005)
                 for j in range(4)]
        host += [("dip.bf16.weight_cast", lo, lo + 1e-5)] * 108
    return _trace(host)


def test_readers_on_a_synthetic_trace():
    w = _window(_two_steps())
    got = {name: harness.load_reader("metrics", name)(w) for name in NEW}
    assert got == pytest.approx({
        "train.host_ms_per_step": 150.0,        # (100 + 200) / 2
        "adam.host_ms_per_step": 20.0,          # 8 x 5 ms over 2 steps
        "data.queue_wait_ms": 3.0,              # (2 + 4) / 2
        "bf16.weight_casts_per_step": 108.0})
    assert spans.count(w.trace, "dip.step") == 2
    assert spans.durations(w.trace, "dip.step") == pytest.approx([0.1, 0.2])


@pytest.mark.parametrize("trace", [None, "no spans", "empty"])
def test_readers_read_nothing_without_spans(trace):
    if trace == "no spans":
        trace = _trace([("portbench.step", 0.0, 1.0),
                        ("aten::conv2d", 0.1, 0.2)])
    elif trace == "empty":
        trace = T.Trace(window_s=1.0)
    for name in NEW:
        assert harness.load_reader("metrics", name)(_window(trace)) is None
    assert spans.count(trace, "dip.step") == 0


def test_span_names_fall_in_no_kernel_class():
    from deepinpainting_torch.utils.profiling import SPANS
    keys = [k for _, ks in T.CLASSES for k in ks]
    assert not [(n, k) for n in SPANS for k in keys if k in n.lower()]
    assert all(T.classify(n) == T.OTHER for n in SPANS)


def test_from_events_leaves_out_the_device_copy_of_a_span():
    from torch.autograd import DeviceType
    from deepinpainting_torch.utils.profiling import SPANS

    def ev(name, dev, start, dur):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                               start_ns=lambda: start, duration_ns=lambda: dur)

    base = 1_700_000_000_000_000_000
    kernels = [ev("aten::conv2d", DeviceType.CPU, base, 5_000),
               ev("conv_kernel", DeviceType.CUDA, base + 1_000, 2_500),
               ev("multi_tensor_apply_kernel", DeviceType.CUDA, base + 6_000,
                  1_000)]
    # each span on the host and its copy on the device's timeline, which
    # reaches past every kernel
    mirrored = [ev(n, d, base + 10 * i, 20_000) for i, n in enumerate(SPANS)
                for d in (DeviceType.CPU, DeviceType.CUDA)]
    plain = T.from_events(kernels, 1e-5)
    traced = T.from_events(kernels + mirrored, 1e-5)
    assert traced.dev_names == plain.dev_names == ["conv_kernel",
                                                   "multi_tensor_apply_kernel"]
    assert plain.busy_s == pytest.approx(3.5e-6)
    assert traced.busy_s == pytest.approx(plain.busy_s)
    assert traced.seconds_by_class() == pytest.approx(
        plain.seconds_by_class())
    assert sorted(set(traced.host_names) - set(plain.host_names)) \
        == sorted(SPANS)


def test_traced_run_on_the_cpu_reads_the_spans():
    """The 512 px bf16 cell cut to the CPU test's size, traced: its line
    carries each new metric, the casts a whole number a step."""
    r = harness.run_cell(tiny_cell("train-512-bf16"), 2**31 + 5, 1.0, True,
                         "cpu", cfg_override=TINY)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["train.host_ms_per_step"] > 0
    assert 0 < got["adam.host_ms_per_step"] < got["train.host_ms_per_step"]
    assert got["data.queue_wait_ms"] >= 0
    casts = got["bf16.weight_casts_per_step"]
    assert casts > 0 and casts == int(casts)
