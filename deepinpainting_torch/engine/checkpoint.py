"""Checkpoint / resume: one file a saved epoch holding the whole training
state (counterpart of deepinpainting_tpu/engine/checkpoint.py, which keeps
one orbax checkpoint an epoch).

`{directory}/epoch_{N}.pt` is `TrainState.state_dict()` with every tensor
on the host: the four trainable networks, the frozen VGG, the four Adam
optimisers (moments, step counts, learning rate) and the step count, so a
resume is exact.  Each file is written under a temporary name and renamed
into place, so a crash never leaves a partial checkpoint under an epoch's
name.  Per-network .npz export/import in the JAX package's flat key layout
is kept for interop with it.

In a data-parallel run (`group`, parallel/mesh.py) every rank holds the
same state: rank 0 alone writes, every rank restores from the same
directory, and the file is the same object a one-process run writes, so
a run of W ranks resumes from a one-process checkpoint and the other way
round.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..parallel.collectives import broadcast_flag
from .state import TrainState

_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def _to_host(obj):
    """A copy of a nested state_dict with every tensor in host memory (the
    copies from the card go to pinned memory without blocking; the caller
    synchronises)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", non_blocking=True, copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    """Saves and restores TrainStates under `{checkpoints_dir}/{name}`.

    config.json: a training manager (cfg.is_train) writes it at
    construction only when none exists, so a resume that fails (a typo'd
    epoch) cannot destroy the original run's record; its first save then
    records the config that ran.  A restore-only manager (is_train=False,
    as evaluation builds it) never writes it.

    async_save: save() copies every tensor to host memory before it
    returns, because the next train step updates the live tensors in
    place; only the disk write runs in a background thread, so it overlaps
    the trainer's validation pass.  One write is in flight at a time;
    wait(), restore() and the listings finish it first and raise its
    error, if it had one.

    group: a torch.distributed group whose ranks all call save, wait,
    restore and the listings at the same points.  Rank 0 alone writes
    (config.json included); once a save's file is in place, every rank
    passes a barrier that carries rank 0's outcome (in wait(), so an async
    write still overlaps the validation pass), and a failed write raises on
    every rank.
    """

    def __init__(self, cfg: Config, directory: Optional[str] = None,
                 max_to_keep: Optional[int] = None,
                 async_save: bool = False, group=None):
        directory = directory or os.path.join(cfg.checkpoints_dir, cfg.name)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._cfg = cfg
        self._group = group
        self.writes = group is None or torch.distributed.get_rank(group) == 0
        self._config_written = not (cfg.is_train and self.writes)
        cfg_path = os.path.join(self.directory, "config.json")
        if not self._config_written and not os.path.exists(cfg_path):
            cfg.save(cfg_path)
            self._config_written = True
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False     # a save whose barrier has not run yet
        # the newest save's figures: ms until save() returned, ms until the
        # file was in place, and its size in bytes
        self.last_save: Dict[str, float] = {}

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def save(self, epoch: int, state: TrainState) -> None:
        """The reference's model.save(epoch), every network and optimiser."""
        self.wait()
        self._pending = self._group is not None
        if not self.writes:
            return
        if not self._config_written:
            self._cfg.save(os.path.join(self.directory, "config.json"))
            self._config_written = True
        t0 = time.perf_counter()
        host = _to_host(state.state_dict())
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.last_save = {"blocking_ms": (time.perf_counter() - t0) * 1e3}
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write, args=(epoch, host, t0), daemon=True)
            self._writer.start()
        else:
            self._write(epoch, host, t0)
            self.wait()

    def _write(self, epoch: int, host: dict, t0: float) -> None:
        try:
            path = self.path(epoch)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(host, tmp)
            os.replace(tmp, path)
            self.last_save.update(total_ms=(time.perf_counter() - t0) * 1e3,
                                  bytes=os.path.getsize(path))
            if self.max_to_keep:
                for old in self._epochs()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        except BaseException as e:   # raised by wait() in the caller
            self._error = e

    def wait(self) -> None:
        """Finish the write in flight, raising its error if it failed (in
        a group: on every rank, after the barrier)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._pending:
            self._pending = False
            if not broadcast_flag(self._error is None, self._group) \
                    and self._error is None:
                raise RuntimeError(
                    f"rank 0 failed to write a checkpoint under "
                    f"{self.directory}")
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, epoch: int, state: TrainState,
                device: DeviceLike = None) -> TrainState:
        """Load epoch `epoch` into `state` in place (a fresh create_state of
        the same config) and return it.  The file is read onto `device`
        ("cuda" unless given "cpu"), where `state` lives."""
        dev = resolve_device(device)
        sd = torch.load(self._existing(epoch), map_location=dev,
                        weights_only=True)
        state.load_state_dict(sd)
        return state

    def restore_models(self, epoch: int, device: DeviceLike = None):
        """G, P and VGG of epoch `epoch` for serving, in eval mode on
        `device` ("cuda" unless given "cpu"), built from the manager's
        config.  The file is mapped on the host and only those three
        networks' tensors are read and moved to the device: D, F and the
        optimisers are neither built nor loaded.  Each network loads
        strictly."""
        from .inpaint import Models, build_models
        dev = resolve_device(device)
        sd = torch.load(self._existing(epoch), map_location="cpu",
                        mmap=True, weights_only=True)
        with torch.device("meta"):
            models = build_models(self._cfg)
        for name, net in zip(Models._fields, models):
            net.load_state_dict(sd[name], strict=True, assign=True)
        return Models(*(net.to(dev).eval() for net in models))

    def _existing(self, epoch: int) -> str:
        """The path of epoch `epoch`'s file, after the write in flight (it
        may be this epoch); FileNotFoundError if there is none."""
        self.wait()
        if epoch not in self._epochs():
            raise FileNotFoundError(
                f"no checkpoint for epoch {epoch} under {self.directory}; "
                f"available: {self._epochs()}")
        return self.path(epoch)

    def _epochs(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _FILE.match, os.listdir(self.directory)) if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def all_epochs(self) -> List[int]:
        self.wait()
        return self._epochs()

    def close(self) -> None:
        self.wait()


def export_network_npz(module: nn.Module, path: str) -> None:
    """One network as a flat .npz in the JAX package's key layout, which
    its import_network_npz loads (the interop role of the reference's
    per-network state_dict files)."""
    from ..convert.jax_bridge import flat_dict
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat_dict(module))


def import_network_npz(module: nn.Module, path: str) -> nn.Module:
    """Load a flat .npz that export_network_npz of either package wrote
    into `module`; every key must land and every parameter be filled."""
    from ..convert.jax_bridge import load_flat
    with np.load(path) as raw:
        return load_flat(module, raw)
