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

Spatial partitioning (parallel/spatial.py) adds the second axis of a grid
of ranks (`Grid`): a rank holds a slab of rows of every image of its data
group's rows.  `use_grid(grid)` enters both the data group and the
spatial context (`Spatial`), also per thread; a layer in a sharded region
(`current_spatial()` not None) works on its slab and exchanges or gathers
rows through the primitives below, and a region that runs on whole images
on every rank of the sp group (`replicated()`) reads no spatial context.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, NamedTuple, Optional, Sequence

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


class Spatial(NamedTuple):
    """A sharded region's context: this rank holds slab `index` of `size`
    equal slabs of rows of every image of the step."""
    group: dist.ProcessGroup       # the ranks that hold the other slabs
    index: int
    size: int
    norm_group: dist.ProcessGroup  # every rank of the grid: the (N, H, W)
                                   # sums of a sharded BatchNorm


class Grid(NamedTuple):
    """One rank's place in an n_data x n_sp grid of ranks (grid rank
    d * n_sp + s, sp fastest, as the JAX package's devices.reshape(n_data,
    n_sp)): it holds data group d's rows of each global batch and slab s
    of their images.  parallel/spatial.py builds one; a bare process group
    is the data-parallel grid (n_sp 1)."""
    n_data: int
    n_sp: int
    data_index: int
    sp_index: int
    world: dist.ProcessGroup           # the grid: gradients, metrics
    data: Optional[dist.ProcessGroup]  # same slab (None when n_data is 1)
    sp: Optional[dist.ProcessGroup]    # same rows (None when n_sp is 1)

    @classmethod
    def data_parallel(cls, group: dist.ProcessGroup) -> "Grid":
        return cls(dist.get_world_size(group), 1, dist.get_rank(group), 0,
                   group, group, None)

    def spatial(self) -> Optional[Spatial]:
        """The sharded regions' context (None: no spatial axis)."""
        if self.sp is None:
            return None
        return Spatial(self.sp, self.sp_index, self.n_sp, self.world)


def as_grid(group) -> Optional[Grid]:
    """None, a Grid, or a process group (the data-parallel grid)."""
    if group is None or isinstance(group, Grid):
        return group
    return Grid.data_parallel(group)


def current_spatial() -> Optional[Spatial]:
    """The spatial context in force in this thread (None: whole images)."""
    return getattr(_GROUP, "spatial", None)


@contextlib.contextmanager
def use_spatial(spatial: Optional[Spatial]):
    """Run the block (in this thread) on slabs under `spatial` (None: on
    whole images)."""
    prev = current_spatial()
    _GROUP.spatial = spatial
    try:
        yield
    finally:
        _GROUP.spatial = prev


def replicated():
    """Run the block on whole images, the same work on every rank of the
    sp group (the gathered regions of parallel/spatial.py)."""
    return use_spatial(None)


@contextlib.contextmanager
def use_grid(grid: Optional[Grid]):
    """Run the block as one rank of `grid`: its data group for the batch
    reductions, its spatial context for the layers."""
    with use_group(None if grid is None else grid.data), \
            use_spatial(None if grid is None else grid.spatial()):
        yield


def full_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """In a sharded region the whole image from this rank's slab `x`
    (gather_rows), else `x`."""
    sp = current_spatial()
    return x if sp is None else gather_rows(x, sp.group, sp.index, sp.size,
                                            dim)


def own_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """In a sharded region this rank's slab of the whole image `x`
    (slice_rows), else `x`."""
    sp = current_spatial()
    return x if sp is None else slice_rows(x, sp.index, sp.size, dim)


def must_gather(h: int, stride: int, halo: int) -> bool:
    """True in a sharded region when a level whose first layer has
    `stride` and needs `halo` rows of a neighbour cannot run on slabs of
    `h` rows (the counterpart of the JAX package's
    constrain_unshardable_spatial): such a level runs on the gathered
    image."""
    return current_spatial() is not None and (h % stride or h < halo)


def spatial_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `t`; in a sharded region over every
    slab of the image (an all-reduced sum, with autograd)."""
    sp = current_spatial()
    if sp is None:
        return torch.mean(t)
    return all_reduce_sum(t.sum(), sp.group) / (t.numel() * sp.size)


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


def all_reduce_max(x: torch.Tensor, group: dist.ProcessGroup
                   ) -> torch.Tensor:
    """The elementwise maximum of `x` over the group's ranks, on every
    rank (a new tensor; no autograd: int8's activation scale, inference
    only).  Gloo runs MAX on CUDA tensors as NCCL does."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def batch_group() -> Optional[dist.ProcessGroup]:
    """The ranks over which this region's activations are split: in a
    sharded region every rank of the grid (rows and slabs), elsewhere the
    data group in force (None: one process, or a replicated region of a
    grid with one data group).  A reduction over a whole activation, as
    the JAX package's one-device program takes it, reduces over these."""
    sp = current_spatial()
    return current_group() if sp is None else sp.norm_group


# ---- spatial partitioning: the rows of an image split over ranks ----------
#
# Under spatial partitioning (parallel/spatial.py) rank s of an sp group of
# n holds rows [s*h, (s+1)*h) of every image (dimension `dim`, H).  The
# three primitives below move rows between those slabs.  Their backward
# passes assume the step's objective is the sum of every rank's loss (the
# rule of parallel/spatial.py), so a value every rank reads takes the sum
# of their gradients.  Each one is an all_reduce of a zero-padded buffer
# (a rank writes its own part, the sum is the concatenation): gloo takes
# CUDA tensors for all_reduce and broadcast only, so the CPU, gloo ranks
# sharing a card and NCCL all run this one path.

class _HaloExchange(torch.autograd.Function):
    """The slab with `above` rows of the rank before it and `below` rows
    of the rank after it; zeros past the image's first and last rows."""

    @staticmethod
    def forward(ctx, x, group, index, size, above, below, dim):
        ctx.args = (group, index, size, above, below, dim)
        h = x.shape[dim]
        # slot s: its last `above` rows (rank s+1's halo above) and its
        # first `below` rows (rank s-1's halo below)
        buf = _slots(x, size, index, above + below, dim,
                     [x.narrow(dim, h - above, above),
                      x.narrow(dim, 0, below)])
        dist.all_reduce(buf, group=group)
        before = (buf[index - 1].narrow(dim, 0, above) if index > 0
                  else _zero_rows(x, above, dim))
        after = (buf[index + 1].narrow(dim, above, below)
                 if index < size - 1 else _zero_rows(x, below, dim))
        return torch.cat([before, x, after], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        group, index, size, above, below, dim = ctx.args
        h = grad.shape[dim] - above - below
        # the halo rows' gradients go back to the ranks that own the rows
        buf = _slots(grad, size, index, above + below, dim,
                     [grad.narrow(dim, 0, above),
                      grad.narrow(dim, above + h, below)])
        dist.all_reduce(buf, group=group)
        g = grad.narrow(dim, above, h).clone()
        if index < size - 1:
            g.narrow(dim, h - above, above).add_(
                buf[index + 1].narrow(dim, 0, above))
        if index > 0:
            g.narrow(dim, 0, below).add_(buf[index - 1].narrow(dim, above,
                                                                below))
        return g, None, None, None, None, None, None


def _zero_rows(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


def _slots(x: torch.Tensor, size: int, index: int, rows: int, dim: int,
           parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """A zero [size, ...] buffer of `rows`-row slots whose slot `index`
    holds `parts` concatenated along `dim`."""
    shape = list(x.shape)
    shape[dim] = rows
    buf = x.new_zeros([size] + shape)
    torch.cat(list(parts), dim=dim, out=buf[index])
    return buf


def halo_exchange(x: torch.Tensor, group: dist.ProcessGroup, index: int,
                  size: int, above: int, below: int, dim: int = 2
                  ) -> torch.Tensor:
    """Rank `index` of the `size` ranks of `group`: its slab `x` with the
    previous rank's last `above` rows before it and the next rank's first
    `below` rows after it (zeros at the image's top and bottom), along
    `dim`.  Backward: the halo rows' gradients are added to the rows they
    came from.  Every slab needs at least max(above, below) rows."""
    h = x.shape[dim]
    if h < max(above, below):
        raise ValueError(
            f"a slab of {h} row(s) cannot lend a halo of {above} row(s) "
            f"above and {below} below (rows come from the adjacent rank "
            "only)")
    return _HaloExchange.apply(x.contiguous(), group, index, size, above,
                               below, dim)


class _GatherRows(torch.autograd.Function):
    """Every slab's rows, concatenated in rank order, on every rank;
    backward: the sum over the ranks of the upstream gradient, this rank's
    rows of it."""

    @staticmethod
    def forward(ctx, x, group, index, size, dim):
        ctx.args = (group, index, dim, x.shape[dim])
        buf = _slots(x, size, index, x.shape[dim], dim, [x])
        dist.all_reduce(buf, group=group)
        return torch.cat(buf.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        group, index, dim, h = ctx.args
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return grad.narrow(dim, index * h, h), None, None, None, None


def gather_rows(x: torch.Tensor, group: dist.ProcessGroup, index: int,
                size: int, dim: int = 2) -> torch.Tensor:
    """The whole image from rank `index`'s slab `x`: every rank's rows
    along `dim`, in rank order, on every rank of `group` (with
    autograd)."""
    return _GatherRows.apply(x.contiguous(), group, index, size, dim)


def slice_rows(x: torch.Tensor, index: int, size: int, dim: int = 2
               ) -> torch.Tensor:
    """Rank `index`'s slab of a whole image `x` that every rank holds (the
    inverse of gather_rows).  No communication either way: autograd's own
    backward of a narrow pads this rank's gradient with zeros, and under
    the sum-of-losses rule the replicated computation that made `x` then
    collects every rank's part through its own gather."""
    if x.shape[dim] % size:
        raise ValueError(f"{x.shape[dim]} rows do not split into {size} "
                         "equal slabs")
    h = x.shape[dim] // size
    return x.narrow(dim, index * h, h)


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
