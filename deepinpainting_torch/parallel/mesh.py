"""Data parallelism over a torch.distributed process group (counterpart of
deepinpainting_tpu/parallel/mesh.py).

Torch has no device mesh: a process group of W ranks, one device each,
takes the place of the JAX package's 1-D data mesh.  The semantics are the
JAX package's, not DistributedDataParallel's: a data-parallel step is the
one-process step on the global batch.  Each rank holds a W-th of the batch
and a replica of the state; the means over the batch inside the losses and
the train-mode BatchNorm moments are taken over the global batch
(parallel/collectives.py), the gradients of each phase are averaged over
the ranks in one all-reduce, and Adam then steps identically everywhere.
The step's metrics are the global ones, the same on every rank.

`init_distributed` sets the group up (env:// as torchrun gives it, or an
explicit coordinator), `process_batch_rows` / `shard_batch` say which rows
of each global batch a rank holds, `replicate_state` makes every rank's
state rank 0's, and `make_dp_train_step` / `make_dp_eval_step` are the
engine's steps in the group.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..engine.inpaint import make_eval_step, make_train_step
from ..engine.state import NETWORKS, TRAINED
from . import collectives

Rows = Union[Tuple[int, int], List[Tuple[int, int]]]


def init_distributed(device: DeviceLike = "cuda",
                     backend: Optional[str] = None,
                     coordinator: Optional[str] = None,
                     num_processes: int = 0,
                     process_id: int = -1) -> torch.device:
    """Join the process group and return this rank's device.

    With coordinator / num_processes / process_id omitted the group comes
    from the environment (env://: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, as torch.distributed.run sets them), the counterpart of
    jax.distributed.initialize()'s autodetection; with them it meets at
    tcp://coordinator (a coordinator with a scheme, file://PATH, is used as
    it is).  The three are given together or not at all.

    The backend follows the device, nccl for "cuda" and gloo for "cpu";
    another only when `backend` names it (gloo lets several ranks share
    one card).  On "cuda" the device is cuda:LOCAL_RANK (the rank modulo
    the card count where LOCAL_RANK is unset), resolved as every entry
    point resolves it: there is no fallback to the CPU.
    """
    given = [bool(coordinator), num_processes > 0, process_id >= 0]
    if any(given) and not all(given):
        raise ValueError(
            "coordinator/num_processes/process_id must be given together "
            "(or all omitted, in which case the group is read from the "
            "environment: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)          # raises when no card is present
        rank = process_id if coordinator else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    if coordinator:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dev


def default_group() -> Optional[dist.ProcessGroup]:
    """The world's group once init_distributed (or init_process_group) has
    run, else None: one process."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def check_batch_divisible(batch_size: int, world: int,
                          grad_accum: int = 1) -> None:
    """Fail fast with a readable sentence when the global batch cannot
    split evenly over the ranks (and, with grad_accum k, each of its k
    microbatches too).  The JAX package shrinks its mesh to gcd(batch,
    devices) instead; a torch launcher fixes the world size, so the port
    refuses the batch."""
    k = max(1, grad_accum)
    if batch_size % (k * world):
        what = (f"{world} rank(s)" if k == 1 else
                f"grad_accum={k} microbatches over {world} rank(s)")
        raise ValueError(
            f"batch_size={batch_size} is not divisible by {what}: every "
            f"rank must hold the same number of rows of each "
            f"{'batch' if k == 1 else 'microbatch'}; change batch_size or "
            f"the number of processes")


def grid_shape(batch_size: int, world: int, sp_devices: int,
               grad_accum: int = 1) -> Tuple[int, int]:
    """(n_data, n_sp) of a run of `world` ranks with Config.sp_devices, by
    the JAX package's rules (engine/trainer.py there): sp_devices divides
    the device count, and the data axis is gcd(batch_size, world /
    sp_devices).  Where the gcd is smaller than world / sp_devices the JAX
    package idles the devices it leaves out; a torch launcher starts every
    rank, so the port refuses that world instead, by name.  Each global
    batch (and with grad_accum k each microbatch) splits evenly over the
    data groups."""
    if sp_devices < 1 or world % sp_devices:
        raise ValueError(f"sp_devices={sp_devices} must divide the device "
                         f"count ({world})")
    n_data = world // sp_devices
    used = math.gcd(max(1, batch_size), n_data)
    if used != n_data:
        raise ValueError(
            f"batch_size={batch_size} does not split over the {n_data} "
            f"data-parallel groups that sp_devices={sp_devices} leaves of "
            f"{world} ranks; the JAX package would use {used} of them and "
            f"idle the rest: start {used * sp_devices} processes or change "
            f"batch_size")
    k = max(1, grad_accum)
    if batch_size % (k * n_data):
        raise ValueError(
            f"batch_size={batch_size} does not split into grad_accum={k} "
            f"microbatches over the {n_data} data-parallel group(s) of "
            f"sp_devices={sp_devices}; change batch_size or grad_accum")
    return n_data, sp_devices


def process_batch_rows(batch_size: int, rank: int, world: int,
                       grad_accum: int = 1) -> Rows:
    """The rows of each global batch that rank `rank` of `world` holds.

    grad_accum 1: the contiguous [r*B/W, (r+1)*B/W), as in the JAX
    package.  grad_accum k > 1: microbatch i is the global rows
    [i*B/k, (i+1)*B/k) (the accumulated step splits the global batch), so
    the rank holds its W-th of each, a list of k (lo, hi) slices whose
    concatenation the step splits into its k microbatches.
    """
    check_batch_divisible(batch_size, world, grad_accum)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a group of {world}")
    k = max(1, grad_accum)
    micro = batch_size // k
    per = micro // world
    rows = [(i * micro + rank * per, i * micro + (rank + 1) * per)
            for i in range(k)]
    return rows[0] if k == 1 else rows


def row_index(rows: Rows) -> List[int]:
    """The row numbers that `rows` (one (lo, hi) slice or a list of them)
    selects, in order."""
    pairs = [rows] if isinstance(rows, tuple) else list(rows)
    return [i for lo, hi in pairs for i in range(lo, hi)]


def shard_batch(batch: Dict[str, object], rank: int, world: int,
                grad_accum: int = 1) -> Dict[str, object]:
    """The rank's rows of a host batch that holds the whole global batch
    (numpy arrays or tensors, leading axis the batch)."""
    size = next(iter(batch.values())).shape[0]
    idx = row_index(process_batch_rows(size, rank, world, grad_accum))
    return {k: v[idx] for k, v in batch.items()}


def replicate_state(state, group: Optional[dist.ProcessGroup]):
    """Make every rank's state rank 0's, in place: every parameter and
    buffer of the five networks (BatchNorm running statistics included)
    and the Adam moments, one broadcast a dtype.  Adam's step counts stay
    on the host and are equal wherever the states have taken the same
    steps.  A fresh state drawn from one seed, or one restored from one
    file, is the same everywhere already; this makes it so whatever its
    origin.  Returns `state`."""
    if group is None:
        return state
    tensors = [t for n in NETWORKS
               for t in getattr(state, n).state_dict().values()]
    for n in TRAINED:
        for st in getattr(state, f"opt_{n}").state.values():
            tensors += [v for k, v in st.items()
                        if k != "step" and isinstance(v, torch.Tensor)]
    collectives.broadcast_(tensors, group)
    return state


def make_dp_train_step(cfg: Config, device: DeviceLike, group):
    """train_step(state, batch, generator=None) -> (state, metrics) for
    one rank of `group`: `batch` holds the rank's rows
    (process_batch_rows), `state` is replicated (replicate_state), and the
    step is the one-process step on the global batch.  `generator` feeds
    the rank's dropout (engine/trainer.py seeds one a rank).  A Grid in
    place of the group is the data x sp step of
    spatial.py::make_dp_sp_train_step (batch: the rank's slab)."""
    return make_train_step(cfg, device, group=group)


def make_dp_eval_step(cfg: Config, device: DeviceLike, group):
    """eval_step(state, batch) for one rank of `group` (a process group, or
    a Grid as make_dp_train_step takes it): the outputs of the rank's
    rows, and loss_valid / loss_ipsr of the global batch."""
    return make_eval_step(cfg, device, group=group)
