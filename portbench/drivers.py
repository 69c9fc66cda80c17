"""The general load generators of the serving mixes, read from a traffic
file's parameters.

  closed_loop  `clients` threads, each sending its next request as soon as
               its last one is answered, until the window closes; a
               request's latency runs from when it was sent
  open_loop    requests due on a Poisson schedule at `rate` a second,
               handed to a pool of `senders` threads; each is timed from
               when it was due, so a stall delays the requests behind it

The open schedule of a seed is a fixed set of gaps (the quantiles of the
exponential distribution at the rate) in an order drawn from the seed: every
seed offers the same number of requests over the same span, in another
order.  Answers of the pool entries in `keep` are kept for the check.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Set

import numpy as np

GRACE_S = 60.0        # how long past the close a request is waited for


@dataclass
class Request:
    index: int
    due: float
    sent: float
    done: float
    ok: bool


@dataclass
class Record:
    seconds: float                    # first due -> last answer
    requests: List[Request] = field(default_factory=list)
    answers: Dict[int, list] = field(default_factory=dict)
    lateness: List[float] = field(default_factory=list)   # open loop, s


def _answer(call, i, keep, rec: Record, lock, due, sent):
    try:
        out = call(i)
        ok = True
    except Exception:                       # counted as failed
        out, ok = None, False
    done = time.perf_counter()
    with lock:
        rec.requests.append(Request(i, due, sent, done, ok))
        if ok and i in keep:
            rec.answers.setdefault(i, []).append(np.array(out))


def closed_loop(call: Callable[[int], np.ndarray], clients: int,
                seconds: float, keep: Set[int], n_pool: int) -> Record:
    """Client k sends pool entries k, k + clients, ... until the window
    closes, one at a time."""
    rec, lock = Record(0.0), threading.Lock()
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def client(k):
        j = k
        while time.perf_counter() < deadline:
            now = time.perf_counter()
            _answer(call, j % n_pool, keep, rec, lock, now, now)
            j += clients

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(seconds + GRACE_S)
    rec.seconds = max((r.done for r in rec.requests), default=t0) - t0
    return rec


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the start) of round(rate * seconds) requests, each
    after its gap: the exponential quantiles at `rate` in a seeded order,
    so every seed's last request is due at the same time."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(seed).permutation(gaps)
    return np.cumsum(gaps)


def open_loop(call: Callable[[int], np.ndarray], rate: float, seconds: float,
              seed: int, senders: int, keep: Set[int], n_pool: int) -> Record:
    """Requests k = 0, 1, ... (pool entry k mod n_pool) sent at their due
    times by a dispatcher through `senders` threads; every request is
    waited for, up to GRACE_S past the last due time."""
    due = schedule(rate, seconds, seed)
    rec, lock = Record(0.0), threading.Lock()
    work: "queue.Queue" = queue.Queue()

    def sender():
        while True:
            item = work.get()
            if item is None:
                return
            k, t_due = item
            _answer(call, k % n_pool, keep, rec, lock, t_due,
                    time.perf_counter())

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(senders)]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    for k, d in enumerate(due):
        target = t0 + d
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec.lateness.append(max(0.0, time.perf_counter() - target))
        work.put((k, target))
    for _ in threads:
        work.put(None)
    end = t0 + float(due[-1]) + GRACE_S
    for th in threads:
        th.join(max(0.0, end - time.perf_counter()))
    with lock:
        answered = {r.due for r in rec.requests}
        for k, d in enumerate(due):
            if t0 + d not in answered:      # never came: failed
                rec.requests.append(Request(k % n_pool, t0 + d, math.nan,
                                            time.perf_counter(), False))
    rec.seconds = max(r.done for r in rec.requests) - t0
    return rec
