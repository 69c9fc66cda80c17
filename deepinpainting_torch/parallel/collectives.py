"""The process group a step runs in, and the collectives its layers take.

The JAX package's data-parallel step is the one-device step on the global
batch, compiled under SPMD: every mean over the batch is a mean over the
global batch, because XLA inserts the all-reduces.  Torch has no such
partitioner, so the port's layers that reduce over the batch (the
relativistic means of `losses.ra_gan_loss`, a train-mode
`ops/convs.py::BatchNorm`) ask which group is in force in this thread and
all-reduce their partial sums themselves, with autograd: the gradient of
an all-reduced sum is the sum of every rank's upstream gradient, so the
gradients the ranks then average are those of the global-batch loss.

An entry point enters its group with `use_group(group)`; with none (the
default) the step is one process and those layers reduce locally.  The
group is held per thread, as the conv modes are (ops/convs.py): autograd
may run a checkpointed level's recompute in a thread of its own, and
models/remat.py enters the forward's group again there.

Every rank holds the same number of rows (parallel/mesh.py refuses a batch
the world size does not divide), so a global count is a local count times
the world size.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_GROUP = threading.local()


def current_group() -> Optional[dist.ProcessGroup]:
    """The process group in force in this thread (None: one process)."""
    return getattr(_GROUP, "group", None)


@contextlib.contextmanager
def use_group(group: Optional[dist.ProcessGroup]):
    """Run the block (in this thread) as one rank of `group`."""
    prev = current_group()
    _GROUP.group = group
    try:
        yield
    finally:
        _GROUP.group = prev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks forward; the same sum of the upstream gradients
    backward (each rank's loss reads the sum, so each rank's input feeds
    every rank's loss)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup
                   ) -> torch.Tensor:
    """The sum of `x` over the group's ranks, on every rank, with
    autograd."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    group: dist.ProcessGroup) -> List[torch.Tensor]:
    """The mean of each tensor over the group's ranks, through one
    all-reduce of one flat buffer (no autograd).  The results are views of
    that buffer."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return [chunk.view_as(t) for chunk, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup
               ) -> None:
    """Overwrite `tensors` on every rank with the group's first rank's,
    one broadcast a dtype."""
    src = dist.get_global_rank(group, 0)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for chunk, t in zip(flat.split([t.numel() for t in ts]), ts):
                t.copy_(chunk.view_as(t))


def collective_device(group: dist.ProcessGroup) -> torch.device:
    """Where a collective of host data runs: NCCL takes CUDA tensors only,
    and gloo takes host tensors for every collective (on CUDA tensors it
    runs only all_reduce, broadcast and barrier)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_host(array: np.ndarray, group: dist.ProcessGroup
                    ) -> np.ndarray:
    """Every rank's `array` (the same shape on each), concatenated along
    the first axis in rank order, on every rank."""
    t = torch.from_numpy(np.ascontiguousarray(array)).to(
        collective_device(group))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).cpu().numpy()


def broadcast_flag(flag: bool, group: dist.ProcessGroup) -> bool:
    """The group's first rank's `flag`, on every rank: a barrier that
    carries an outcome."""
    t = torch.tensor([int(flag)], device=collective_device(group))
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return bool(t.item())
