"""Spatial partitioning (SP) over torch.distributed: the rows of every
image split over ranks (counterpart of deepinpainting_tpu/parallel/
spatial.py).

Data parallelism (mesh.py) raises throughput but leaves a batch-1 request
on one device; SP spreads one image's rows over several, each rank
working on a 1/n_sp-height slab of every [B, C, H, W] activation of both
U-Nets.  The JAX package annotates shardings and lets XLA's partitioner
insert the collectives; torch has no partitioner, so the port's layers do
the exchanges themselves whenever a spatial context is in force
(collectives.py::use_grid, per thread; models/remat.py enters it again
for a recompute):

  * every conv and transposed conv takes its neighbours' halo rows
    (collectives.halo_exchange) and runs on the padded slab
    (ops/convs.py);
  * the instance norm's means and variances, and the L1 means, are summed
    over the slabs; a train-mode BatchNorm's moments over the whole grid;
  * the IPSR attention level, a U-Net level whose stride-2 conv cannot
    run on the slab (the bottleneck), VGG16 and the discriminators run on
    the gathered image on every rank of the sp group (the JAX package
    all-gathers their operands, or pins them to batch-only shardings);
  * the mask pyramid is built from the gathered mask, the dropout draws
    the whole image's mask and keeps its rows.

The parameters are replicated.  A rank's loss is the whole loss of its
data group's rows, and the gradients are averaged over the whole grid:
the rule, and why it counts the replicated work once, is in
engine/inpaint.py's docstring.

The grid: n_data x n_sp ranks, rank d * n_sp + s (sp fastest, the JAX
package's devices.reshape(n_data, n_sp)); `make_dp_sp_groups` builds it
(every rank calls it, in the same order), `make_sp_group` the 1 x n grid
of one request's ranks, `place_spatial` gives a rank its rows and slab of
a global batch, and the three builders are the engine's functions on a
grid.  A grid's spatial axis of 1 (sp_devices 1) is the plain path: no
layer exchanges anything, and the step's gradients are averaged over the
grid's ranks as mesh.py's are.

One collective path everywhere: every exchange is an all_reduce of a
zero-padded buffer (collectives.py), which gloo takes on CUDA tensors as
NCCL does.  Point-to-point halos would move n_sp times fewer bytes over
NCCL.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..config import Config
from ..device import DeviceLike
from ..engine.inpaint import make_eval_step, make_inference_fn, make_train_step
from .collectives import Grid
from .mesh import process_batch_rows, row_index


def _groups(member_lists: Sequence[List[int]]) -> List[dist.ProcessGroup]:
    """One group a list of ranks, created by every rank in the same order;
    a list that is the whole world is the world's group."""
    if len(member_lists) == 1:
        return [dist.group.WORLD]
    return [dist.new_group(m) for m in member_lists]


def make_dp_sp_groups(n_data: int, n_sp: int) -> Grid:
    """This rank's place in the n_data x n_sp grid of the world (the
    counterpart of make_dp_sp_mesh).  Every rank of the world calls it,
    in the same order as its other new_group calls."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data < 1 or n_sp < 1 or n_data * n_sp != world:
        raise ValueError(
            f"a grid of {n_data} data group(s) x sp_devices={n_sp} needs "
            f"{n_data * n_sp} ranks; the world has {world}")
    d, s = divmod(rank, n_sp)
    data = _groups([[dd * n_sp + ss for dd in range(n_data)]
                    for ss in range(n_sp)]) if n_data > 1 else None
    sp = _groups([[dd * n_sp + ss for ss in range(n_sp)]
                  for dd in range(n_data)]) if n_sp > 1 else None
    return Grid(n_data, n_sp, d, s, dist.group.WORLD,
                None if data is None else data[s],
                None if sp is None else sp[d])


def make_sp_group(group: Optional[dist.ProcessGroup] = None) -> Grid:
    """The 1 x n grid of `group`'s ranks (default: the world), every rank a
    slab of the same images (the counterpart of make_sp_mesh).  A group of
    one rank has no spatial axis: the plain path."""
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    return Grid(1, n, 0, dist.get_rank(group), group, None,
                group if n > 1 else None)


def slab(batch: Dict[str, object], grid: Grid) -> Dict[str, object]:
    """This rank's slab of rows (axis 1: H of [B, H, W, C] images and
    [B, H, W] masks) of every array of a host batch."""
    out = {}
    for k, v in batch.items():
        h = v.shape[1]
        if h % grid.n_sp:
            raise ValueError(f"{k}: {h} rows do not split over "
                             f"sp_devices={grid.n_sp}")
        per = h // grid.n_sp
        part = v[:, grid.sp_index * per:(grid.sp_index + 1) * per]
        out[k] = (np.ascontiguousarray(part) if isinstance(part, np.ndarray)
                  else part.contiguous())
    return out


def place_spatial(batch: Dict[str, object], grid: Grid,
                  grad_accum: int = 1) -> Dict[str, object]:
    """This rank's part of a global batch (numpy arrays or tensors, leading
    axis the batch): its data group's rows (mesh.py::process_batch_rows),
    and of those its slab of rows."""
    size = next(iter(batch.values())).shape[0]
    idx = row_index(process_batch_rows(size, grid.data_index, grid.n_data,
                                       grad_accum))
    return slab({k: v[idx] for k, v in batch.items()}, grid)


def make_sp_inference_fn(cfg: Config, device: DeviceLike, grid: Grid):
    """infer(G, P, vgg, gt, mask, ref) -> (fake_B, fake_P) with gt, mask and
    ref this rank's slabs of one request's images and the outputs its
    slabs too (the JAX package's out_shardings=(sp, sp));
    engine/inpaint.py::make_inference_fn on the grid."""
    return make_inference_fn(cfg, device, grid)


def make_dp_sp_train_step(cfg: Config, device: DeviceLike, grid: Grid):
    """train_step(state, batch, generator=None) -> (state, metrics) for one
    rank of `grid`: batch holds the rank's rows and slab of the global
    batch (place_spatial), state is replicated (mesh.replicate_state),
    `generator` feeds the dropout and must be the same on the ranks of an
    sp group.  The metrics are the global ones, on every rank."""
    return make_train_step(cfg, device, grid)


def make_dp_sp_eval_step(cfg: Config, device: DeviceLike, grid: Grid):
    """eval_step(state, batch) for one rank of `grid` (batch as the train
    step takes it): the images and per-image metrics of its data group's
    rows, whole; loss_ipsr and loss_valid of the global batch."""
    return make_eval_step(cfg, device, grid)
