"""Request-coalescing micro-batcher (the port's own copy of
deepinpainting_tpu/serve/batcher.py).

Callers submit single items and block on a result; one worker thread
drains the queue, stacks up to `max_batch` items (waiting at most `wait_ms`
for stragglers after the first), runs the supplied batched function once,
and hands each caller its row.  Errors in the batched call propagate to
every waiting caller of that batch.

One difference from the JAX package's copy: a partial batch is not padded
to `max_batch`.  Padding there keeps one static jit shape; PyTorch runs
eagerly, so padded rows would only cost device time.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce single-item calls into batched calls.

    batched_fn: takes a dict of stacked arrays with leading axis n <=
    `max_batch` and returns a sequence/array whose leading axis indexes
    items.
    """

    def __init__(self, batched_fn: Callable[[Dict[str, np.ndarray]], Any],
                 max_batch: int = 8, wait_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batched_fn = batched_fn
        self.max_batch = max_batch
        self.wait_ms = wait_ms
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._closed = False
        # serializes enqueue vs close: an item enqueued under the lock sits
        # AHEAD of the shutdown sentinel in the FIFO, so the worker always
        # processes it before exiting.
        self._submit_lock = threading.Lock()
        self.batches_run = 0
        self.items_served = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- caller side ---------------------------------------------------------
    def submit(self, item: Dict[str, np.ndarray],
               timeout: Optional[float] = None):
        """Block until the item's result is available; raises the batch
        error if the batched call failed."""
        if timeout is None:
            timeout = float(os.environ.get("DIP_BATCH_TIMEOUT", "1800"))
        p = _Pending(item)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError(f"batched inference exceeded {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self, timeout: Optional[float] = None):
        """Idempotent.  Blocks until the worker has finished every item
        enqueued before the close, but at most `timeout` seconds; on
        timeout the queue is drained and stragglers failed."""
        if timeout is None:
            timeout = float(os.environ.get("DIP_BATCH_TIMEOUT", "1800"))
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the worker; FIFO => behind all items
        self._worker.join(timeout)
        timed_out = self._worker.is_alive()
        if timed_out:  # pragma: no cover - needs a hung call
            print(f"[batcher] worker still busy after {timeout}s close "
                  "wait (hung device call?); abandoning it", flush=True)
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.error = RuntimeError("batcher is closed")
                p.event.set()
        if timed_out:  # pragma: no cover - needs a hung call
            # the drain may have consumed the sentinel; re-arm it so the
            # abandoned worker exits if its hung call ever returns
            self._q.put(None)

    # -- worker side ---------------------------------------------------------
    def _collect(self) -> Optional[List[_Pending]]:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        # wait up to wait_ms for stragglers, then take whatever is queued
        t_end = time.monotonic() + self.wait_ms / 1000.0
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            try:
                nxt = self._q.get(timeout=max(0.0, remaining))
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-arm shutdown for the outer loop
                break
            batch.append(nxt)
            if remaining <= 0:
                break
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                keys = batch[0].item.keys()
                stacked = {k: np.stack([np.asarray(p.item[k]) for p in batch])
                           for k in keys}
                out = self.batched_fn(stacked)
                for i, p in enumerate(batch):
                    p.result = _index_result(out, i)
                self.batches_run += 1
                self.items_served += len(batch)
            except BaseException as e:  # propagate to all callers
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()


def _index_result(out, i: int):
    """Pick item i out of a batched result (array, tuple of arrays, or
    dict of arrays)."""
    if isinstance(out, dict):
        return {k: np.asarray(v)[i] for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(np.asarray(v)[i] for v in out)
    return np.asarray(out)[i]
