"""The serving load generators: the open-loop schedule from the seed, and
each request timed from when it was due, against a stub session."""

import threading
import time

import numpy as np
import pytest

from portbench import drivers


def test_schedule_is_reproducible_and_the_same_set_for_every_seed():
    a = drivers.schedule(90.0, 10.0, 2**31 + 12345)
    assert np.array_equal(a, drivers.schedule(90.0, 10.0, 2**31 + 12345))
    b = drivers.schedule(90.0, 10.0, 7)
    assert len(a) == len(b) == 900 and a[-1] == pytest.approx(b[-1])
    assert not np.array_equal(a, b)
    gaps = lambda t: np.sort(np.diff(np.concatenate([[0.0], t])))
    assert np.allclose(gaps(a), gaps(b))
    # the gaps are exponential at the rate: mean 1/rate
    assert gaps(a).mean() == pytest.approx(1 / 90.0, rel=1e-2)


def _stalling_call(stall_at: int, stall_s: float):
    """A session that serves one call at a time in 5 ms, and stalls once."""
    lock = threading.Lock()
    count = [0]

    def call(i):
        with lock:
            count[0] += 1
            time.sleep(stall_s if count[0] == stall_at else 0.005)
            return np.full((2, 2, 3), i % 256, np.uint8)
    return call


def test_open_loop_times_from_the_due_time():
    rec = drivers.open_loop(_stalling_call(5, 0.5), rate=40.0, seconds=2.0,
                            seed=3, senders=16, keep={0, 1, 2}, n_pool=8)
    assert len(rec.requests) == 80 and all(r.ok for r in rec.requests)
    lat = np.array([r.done - r.due for r in rec.requests])
    # the stall delays the requests queued behind it: their latency counts
    # the wait from their due time, up to the stall's length
    assert lat.max() >= 0.4
    assert (lat > 0.1).sum() >= 5
    assert all(r.sent >= r.due for r in rec.requests)
    assert max(rec.lateness) < 0.1
    assert set(rec.answers) == {0, 1, 2}
    assert all(int(a[0, 0, 0]) == i for i, got in rec.answers.items()
               for a in got)


def test_open_loop_counts_a_request_that_never_comes_as_failed(monkeypatch):
    monkeypatch.setattr(drivers, "GRACE_S", 0.3)

    def call(i):
        if i == 3:
            time.sleep(2.0)
        return np.zeros((1,), np.uint8)

    rec = drivers.open_loop(call, rate=20.0, seconds=0.5, seed=1, senders=4,
                            keep=set(), n_pool=10)
    assert len(rec.requests) == 10
    assert sum(not r.ok for r in rec.requests) == 1


def test_closed_loop_keeps_every_client_busy():
    rec = drivers.closed_loop(_stalling_call(0, 0.0), clients=4, seconds=0.5,
                              keep={1}, n_pool=4)
    n = len(rec.requests)
    assert n >= 40 and all(r.ok for r in rec.requests)
    assert rec.seconds >= 0.5
    assert {r.index for r in rec.requests} == {0, 1, 2, 3}
    assert len(rec.answers[1]) >= 1
