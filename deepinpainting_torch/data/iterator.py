"""Batching and prefetching over a host dataset (counterpart of
deepinpainting_tpu/data/iterator.py).

`BatchIterator` yields one shuffled epoch of stacked NHWC numpy batches,
drawing every item's augmentation from its own spawned generator, so the
serial, thread and process backends give the same stream bit for bit, and
the same as the JAX package's for the same dataset and seed.  `prefetch`
runs an iterator in a background thread; `device_batches` also moves each
batch to the device inside that thread, the role of the JAX package's
placement in its prefetch worker.

numpy only at module level: spawned loader workers import this package,
and torch is imported inside device_batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np


class BatchIterator:
    """One shuffled epoch of stacked NHWC batches {'image','mask','ref'}.

    drop_last keeps every step at one batch shape.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, workers: int = 0,
                 backend: str = "process",
                 rows: Union[Tuple[int, int], List[Tuple[int, int]],
                             None] = None):
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} items < batch_size "
                f"{batch_size} with drop_last — every epoch would be empty")
        self.dataset = dataset
        self.batch_size = batch_size
        # rows=(lo, hi), or a list of such slices: materialize only these
        # rows of every global batch, in order (a rank of a data-parallel
        # run decodes the rows it holds, parallel/mesh.py::
        # process_batch_rows), while the shuffle order and the per-item
        # generators stay seed-identical across processes: the full
        # batch's rng spawn happens everywhere; only the fetches are sliced.
        self._sel = None
        if rows is not None:
            pairs = [rows] if isinstance(rows, tuple) else list(rows)
            for lo, hi in pairs:
                if not (0 <= lo < hi <= batch_size):
                    raise ValueError(f"rows={rows} must be non-empty slices "
                                     f"of [0, {batch_size})")
            self._sel = np.concatenate([np.arange(lo, hi)
                                        for lo, hi in pairs])
            if not drop_last:
                # a short tail batch has no consistent per-process rows
                raise ValueError(
                    "rows requires drop_last=True (row slicing needs "
                    "fixed-size global batches; a ragged tail batch has no "
                    "consistent per-process rows)")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        # workers > 0: decode a batch's items in parallel, the role of
        # DataLoader num_workers.  "process" scales (PIL decode and the
        # numpy augmentations hold the GIL); "thread" costs no start-up.
        # Each item gets its own spawned child generator either way, so the
        # stream is the same for any worker count and backend.  The process
        # pool lives on the dataset and persists across epochs/iterators.
        if backend not in ("process", "thread"):
            raise ValueError(f"unknown loader backend {backend!r}")
        if workers < 0:  # auto: parallel decode only helps with spare cores
            import os as _os
            workers = min(8, max(0, (_os.cpu_count() or 1) - 1))
        self.workers = workers if hasattr(dataset, "fetch") else 0
        self.backend = backend
        self._tpool = None
        if self.workers > 0 and backend == "thread":
            from concurrent.futures import ThreadPoolExecutor
            self._tpool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def _select(self, idx):
        """(the batch's dataset indices, their generators) for the rows
        this iterator materializes; the full batch's generators are
        spawned either way.  rows implies drop_last (checked in __init__),
        so idx is a full batch when rows are given."""
        rngs = self.rng.spawn(len(idx))
        if self._sel is None:
            return idx, rngs
        return idx[self._sel], [rngs[i] for i in self._sel]

    def _load(self, idx) -> list:
        if hasattr(self.dataset, "fetch"):
            idx, rngs = self._select(idx)
            if self.workers > 0 and self.backend == "thread":
                return list(self._tpool.map(self.dataset.fetch,
                                            [int(i) for i in idx], rngs))
            return [self.dataset.fetch(int(i), r)
                    for i, r in zip(idx, rngs)]
        if self._sel is not None:
            idx = idx[self._sel]
        return [self.dataset[int(i)] for i in idx]

    def __del__(self):
        if getattr(self, "_tpool", None) is not None:
            self._tpool.shutdown(wait=False)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.workers > 0 and self.backend == "process":
            yield from self._iter_process()
            return
        for idx in self._batch_indices():
            items = self._load(idx)
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _iter_process(self) -> Iterator[Dict[str, np.ndarray]]:
        """Whole batches assembled in worker processes, `workers + 2`
        batches in flight, one IPC round trip a batch.  rngs are spawned in
        submission order, so the batches equal the serial path's."""
        from collections import deque
        from .dataset import _pool_fetch_batch
        pool = self.dataset.get_pool(self.workers)

        def submit(idx):
            idx, rngs = self._select(idx)
            return pool.submit(_pool_fetch_batch, [int(i) for i in idx],
                               rngs)

        it = self._batch_indices()
        futs = deque()
        for idx in it:
            futs.append(submit(idx))
            if len(futs) >= self.workers + 2:
                break
        while futs:
            batch = futs.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                futs.append(submit(nxt))
            yield batch


def prefetch(iterable, depth: int = 2):
    """Run an iterator in a daemon thread with a bounded queue, so host
    decode overlaps device steps.  An exception in the iterator is raised
    in the consumer."""
    q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
    _end = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # surface worker errors to the consumer
            q.put(e)
        q.put(_end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def device_batches(iterable, device, depth: int = 2):
    """Prefetched batches as tensors on `device` (a torch.device or name).

    The upload runs inside the prefetch thread, so batch k+1's copy
    overlaps step k.  On a CUDA device each array goes to pinned memory and
    is copied with non_blocking on a side stream; the consumer's stream
    waits on the copy's event before the step can read the batch, and each
    tensor is recorded on the consumer's stream, so the caching allocator
    does not hand its memory to the side stream while the step still reads
    it.  On the CPU the arrays become tensors without a copy.  Each wait of
    the consumer on the prefetch queue is the span dip.data.wait
    (utils/profiling.py), closed before the batch is handed out.
    """
    import torch
    from ..utils.profiling import span
    dev = torch.device(device)

    def waited(items):
        while True:
            with span("dip.data.wait"):
                item = next(items, None)
            if item is None:
                return
            yield item

    if dev.type != "cuda":
        for batch in waited(prefetch(iterable, depth)):
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return

    def uploaded():
        stream = torch.cuda.Stream(device=dev)
        for batch in iterable:
            with torch.cuda.stream(stream):
                out = {k: torch.from_numpy(v).pin_memory().to(
                    dev, non_blocking=True) for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(stream)
            yield out, done

    for out, done in waited(prefetch(uploaded(), depth)):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        yield out
