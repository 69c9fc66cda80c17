"""The trace arithmetic: the idle share from the union of overlapping
device intervals, the kernel classes, and the breakdown."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import trace as T


def test_union_counts_overlap_once():
    # [0,2) and [1,3) overlap; [2,2.5) lies inside; [5,6) apart
    s = np.array([0.0, 1.0, 5.0, 2.0])
    e = np.array([2.0, 3.0, 6.0, 2.5])
    assert T.union_seconds(s, e) == pytest.approx(4.0)
    # a plain sum would read 5.5
    assert (e - s).sum() == pytest.approx(5.5)


def test_union_nested_and_touching():
    s = np.array([0.0, 0.1, 0.2, 1.0, 2.0])
    e = np.array([1.0, 0.9, 0.3, 2.0, 2.5])
    assert T.union_seconds(s, e) == pytest.approx(2.5)
    assert T.union_seconds(np.zeros(0), np.zeros(0)) == 0.0


def test_union_matches_a_brute_force_grid():
    rng = np.random.default_rng(0)
    s = rng.uniform(0, 10, 200)
    e = s + rng.exponential(0.05, 200)
    grid = np.arange(0, 11, 1e-4) + 5e-5
    covered = ((grid[:, None] >= s) & (grid[:, None] < e)).any(1).sum() * 1e-4
    assert T.union_seconds(s, e) == pytest.approx(covered, abs=2e-3)


def test_gaps_are_the_complement():
    s, e = np.array([1.0, 1.5, 4.0]), np.array([2.0, 3.0, 5.0])
    lo, hi = T.gaps(s, e, 0.0, 6.0)
    assert lo.tolist() == [0.0, 3.0, 5.0] and hi.tolist() == [1.0, 4.0, 6.0]
    assert (hi - lo).sum() + T.union_seconds(s, e) == pytest.approx(6.0)


def test_idle_share_and_classes():
    tr = T.Trace(window_s=10.0,
                 dev_names=["sm90_xmma_fprop_implicit_gemm",
                            "scan_stream_kernel",
                            "multi_tensor_apply_kernel", "Memcpy HtoD",
                            "sm90_xmma_gemm_f32f32", "elementwise_kernel"],
                 dev_start=np.array([0.0, 2.0, 3.0, 2.5, 6.0, 8.0]),
                 dev_end=np.array([2.0, 3.0, 4.0, 3.5, 7.0, 9.0]))
    assert tr.busy_s == pytest.approx(6.0)
    by = tr.seconds_by_class()
    assert by == pytest.approx({"convolution": 2.0, "scan": 1.0,
                                "optimiser": 1.0, "copy": 1.0, "matmul": 1.0,
                                "elementwise/other": 1.0})
    assert T.classify("kbar_build_kernel") == "kbar"


def test_breakdown_names_gaps_by_the_innermost_host_event():
    tr = T.Trace(window_s=10.0, dev_names=["k"], dev_start=np.array([0.0]),
                 dev_end=np.array([1.0]),
                 host_names=["portbench.step", "cudaStreamSynchronize"],
                 host_start=np.array([0.0, 1.5]),
                 host_end=np.array([10.0, 9.5]))
    b = tr.breakdown()
    assert b["device_ops"] == [["k", 1.0]]
    assert b["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert b["idle_gaps"][0][1] == pytest.approx(9.0)


def test_from_events_splits_device_and_host():
    from torch.autograd import DeviceType

    def ev(name, dev, start, dur):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                               start_ns=lambda: start, duration_ns=lambda: dur)

    base = 1_700_000_000_000_000_000
    tr = T.from_events([ev("aten::conv", DeviceType.CPU, base, 5_000),
                        ev("portbench.step", DeviceType.CPU, base, 9_000),
                        ev("conv_kernel", DeviceType.CUDA, base + 1_000,
                           2_500),
                        ev("scan_stream_kernel", DeviceType.CUDA, base + 2_000,
                           2_000),
                        # the host span mirrored onto the device's timeline
                        ev("portbench.step", DeviceType.CUDA, base, 9_000)],
                       1e-5)
    assert tr.dev_names == ["conv_kernel", "scan_stream_kernel"]
    assert tr.busy_s == pytest.approx(3.0e-6)
    assert tr.host_end[0] == pytest.approx(5e-6)
