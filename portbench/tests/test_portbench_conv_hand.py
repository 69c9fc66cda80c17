"""The reader of conv.hand_calls_per_step: the program's dip.hand.direct2d
spans (one a launch of its hand-written f32 convolution) over the window's
steps, and None where the program opens no such span."""

import numpy as np
import pytest

from portbench import harness
from portbench import trace as T

SPAN = "dip.hand.direct2d"


def _window(host, steps):
    names = [h[0] for h in host]
    trace = T.Trace(window_s=1.0, dev_names=["k"], dev_start=np.array([0.0]),
                    dev_end=np.array([0.5]), host_names=names,
                    host_start=np.array([h[1] for h in host]),
                    host_end=np.array([h[2] for h in host]))
    return harness.Window("train", 1.0, steps=steps, images=8 * steps,
                          trace=trace)


def _read(w):
    return harness.load_reader("metrics", "conv.hand_calls_per_step")(w)


@pytest.mark.parametrize("n, steps", [(72, 1), (144, 2), (96, 3), (1, 4)])
def test_n_spans_over_s_steps_read_n_over_s(n, steps):
    host = [("portbench.step", 0.0, 1.0), ("aten::conv2d", 0.1, 0.2)]
    host += [(SPAN, 0.001 * i, 0.001 * i + 1e-4) for i in range(n)]
    assert _read(_window(host, steps)) == pytest.approx(n / steps)


@pytest.mark.parametrize("trace", [None, "no spans", "empty"])
def test_no_span_reads_none(trace):
    if trace is None:
        w = harness.Window("train", 1.0, steps=2, images=16, trace=None)
    elif trace == "empty":
        w = harness.Window("train", 1.0, steps=2, images=16,
                           trace=T.Trace(window_s=1.0))
    else:
        w = _window([("portbench.step", 0.0, 1.0),
                     ("dip.bf16.weight_cast", 0.1, 0.2)], 2)
    assert _read(w) is None


def test_the_span_falls_in_no_kernel_class():
    assert T.classify(SPAN) == T.OTHER
