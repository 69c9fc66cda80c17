"""The epoch trainer (counterpart of deepinpainting_tpu/engine/trainer.py).

The reference's training loop (train.ipynb cell 2): shuffled epochs, the
D-then-G step, a 2x2 visual dump every `display_freq` images, a checkpoint
every `save_epoch_freq` epochs, a validation pass computing the L1 loss of
the eval step, EarlyStopping, the learning rate stepped once an epoch, and
the train/valid loss-curve figure.

On one device (a card unless given device="cpu"): batches are decoded by
loader workers and uploaded in a background thread
(data/iterator.py::device_batches), step metrics stay on the device and
come to the host once every `metrics_every` steps, and the checkpoint's
disk write overlaps the validation pass.

Data-parallel (once torch.distributed is initialized, parallel/mesh.py::
init_distributed; `_cli.py train --multihost`): every rank walks the same
seeded epoch and decodes only its rows of each global batch, and runs the
data-parallel step, whose metrics and validation losses are the global
ones, so every rank takes the same decisions (the NaN guard, early
stopping, the plateau schedule).  Rank 0 alone writes metrics, visuals,
the config and checkpoints, as the JAX package's process 0 does; the
grid shows the global batch's first image, which rank 0 holds.

Spatially partitioned (cfg.sp_devices > 1, in a group; `_cli.py train
--multihost --sp_devices k`): the ranks form the JAX package's data x sp
grid (parallel/mesh.py::grid_shape, parallel/spatial.py), each decoding
its data group's rows of every global batch and keeping its slab of their
rows; the steps are the grid's, the dropout's stream is its data group's,
and rank 0 of the world writes, as above.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.iterator import BatchIterator, device_batches
from ..device import DeviceLike, resolve_device
from ..parallel import mesh, spatial
from ..utils import imaging
from ..utils.metrics import MetricsLogger
from ..utils.profiling import trace
from .checkpoint import CheckpointManager
from .inpaint import create_state
from .schedules import EarlyStopping, PlateauScheduler, lr_for_epoch
from .state import TrainState, set_learning_rate


class _NullLogger:
    """The metrics sink of every rank but 0: the ranks compute the same
    global metrics, and rank 0 writes them."""

    def log_step(self, *a, **k): pass
    def log_epoch(self, *a, **k): pass
    def save_loss_plot(self): pass
    def close(self): pass


class Trainer:
    def __init__(self, cfg: Config, train_dataset, valid_dataset=None, *,
                 out_dir: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.train_dataset = train_dataset
        self.valid_dataset = valid_dataset
        self.out_dir = out_dir or os.path.join(cfg.checkpoints_dir, cfg.name)
        os.makedirs(self.out_dir, exist_ok=True)
        # a process group, if torch.distributed is initialized: this
        # process is one rank of a data-parallel run, or of a data x sp
        # grid with sp_devices > 1
        self.group = mesh.default_group()
        world = (1 if self.group is None
                 else torch.distributed.get_world_size(self.group))
        self.grid = None
        if cfg.sp_devices > 1:
            self.grid = spatial.make_dp_sp_groups(*mesh.grid_shape(
                cfg.batch_size, world, cfg.sp_devices, cfg.grad_accum))
        self.rank, self._rows = 0, None
        data_index = 0
        if self.group is not None:
            self.rank = torch.distributed.get_rank(self.group)
            data_index, n_data = self.rank, world
            if self.grid is not None:
                data_index, n_data = self.grid.data_index, self.grid.n_data
            self._rows = mesh.process_batch_rows(
                cfg.batch_size, data_index, n_data, cfg.grad_accum)
        self.primary = self.rank == 0
        self.train_step = mesh.make_dp_train_step(cfg, self.device,
                                                  self.grid or self.group)
        self.eval_step = mesh.make_dp_eval_step(cfg, self.device,
                                                self.grid or self.group)
        # dropout's stream: from its own seed, so it differs from the JAX
        # package's (parity runs keep use_dropout off, the default), and
        # one a data group, so that the groups' rows draw different masks
        # and the ranks of an sp group draw the same whole-image mask
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1 + (data_index << 32))
        self.ckpt = CheckpointManager(cfg, async_save=True, group=self.group)
        self.logger = (MetricsLogger(self.out_dir) if self.primary
                       else _NullLogger())
        self.early = EarlyStopping(cfg.early_stop_patience)
        self.plateau = (PlateauScheduler(cfg.lr)
                        if cfg.lr_policy == "plateau" else None)

    # -- state ---------------------------------------------------------------
    def resume_epoch(self) -> Optional[int]:
        """Epoch to resume from, or None.  which_epoch="latest" resolves to
        the newest checkpoint on disk."""
        if not (self.cfg.continue_train and self.cfg.which_epoch):
            return None
        if self.cfg.which_epoch == "latest":
            ep = self.ckpt.latest_epoch()
            if ep is None:
                raise FileNotFoundError(
                    f"continue_train with which_epoch=latest but no "
                    f"checkpoints under {self.ckpt.directory}")
            return ep
        return int(self.cfg.which_epoch)

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A fresh state drawn from cfg.seed (or `generator`), restored
        from the resume epoch when there is one."""
        generator = generator or torch.Generator().manual_seed(self.cfg.seed)
        state = create_state(self.cfg, generator, self.device)
        ep = self.resume_epoch()
        if ep is not None:
            state = self.ckpt.restore(ep, state, self.device)
        return mesh.replicate_state(state, self.group)

    def _batches(self, it):
        """The iterator's host batches on the device, each this rank's slab
        of rows under a grid."""
        batches = iter(it)
        if self.grid is not None:
            batches = (spatial.slab(b, self.grid) for b in batches)
        return device_batches(batches, self.device)

    # -- epochs --------------------------------------------------------------
    def train_epoch(self, state: TrainState, epoch: int, total_steps: int):
        """One epoch; returns (state, mean train loss, total_steps), where
        total_steps counts images, as the reference's counter does."""
        cfg = self.cfg
        it = BatchIterator(self.train_dataset, cfg.batch_size,
                           seed=cfg.seed + epoch, workers=cfg.data_workers,
                           rows=self._rows)
        losses = []
        window = []   # (images so far, wall time, metrics on the device)
        every = max(1, cfg.metrics_every)

        def flush():
            # One host copy of the whole window's metrics; every step still
            # gets its own CSV row with its own wall time, and the NaN guard
            # checks the window (a halt comes at most every-1 steps late).
            if not window:
                return
            keys = list(window[0][2])
            rows = torch.stack([torch.stack([m[k] for k in keys])
                                for _, _, m in window]).cpu().numpy()
            for (step_n, t_step, _), row in zip(window, rows):
                m = dict(zip(keys, map(float, row)))
                losses.append(m["loss"])
                if cfg.debug_nan and not np.isfinite(m["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss at step {step_n}: {m}")
                self.logger.log_step(step_n, m, when=t_step)
            window.clear()

        for batch in self._batches(it):
            state, metrics = self.train_step(state, batch, self.generator)
            total_steps += cfg.batch_size
            window.append((total_steps, time.time(), metrics))
            if len(window) >= every:
                flush()
            if cfg.display_freq and total_steps % cfg.display_freq == 0:
                self._dump_visuals(state, batch, epoch, total_steps)
        flush()
        return state, float(np.mean(losses)) if losses else float("nan"), \
            total_steps

    def validate(self, state: TrainState) -> float:
        """Mean loss_valid of the eval step over the validation set, one
        host copy for the whole pass."""
        if self.valid_dataset is None:
            return float("nan")
        it = BatchIterator(self.valid_dataset, self.cfg.batch_size,
                           shuffle=False, workers=self.cfg.data_workers,
                           rows=self._rows)
        losses = [self.eval_step(state, b)["loss_valid"]
                  for b in self._batches(it)]
        if not losses:
            return float("nan")
        return float(np.mean(torch.stack(losses).cpu().numpy(),
                             dtype=np.float64))

    def _dump_visuals(self, state, batch, epoch, step):
        # train.ipynb cell 2's display_freq grid: real_A, real_B, fake_P,
        # fake_B of the batch's first image
        vis = self.eval_step(state, batch)["visuals"]   # collective
        if not self.primary:
            return
        imgs = [vis[k][0].cpu().numpy()
                for k in ("real_A", "real_B", "fake_P", "fake_B")]
        imaging.save_grid(imgs, os.path.join(
            self.out_dir, "saveimg", f"Epoch_({epoch})_({step}).jpg"),
            nrow=2)

    # -- full run ------------------------------------------------------------
    def fit(self, state: Optional[TrainState] = None, *,
            profile_dir: Optional[str] = None,
            stop_epoch: Optional[int] = None) -> TrainState:
        """Train from `state` (else init_state()'s) to the last epoch, or
        to `stop_epoch` on the same schedule (a later run resumes from its
        checkpoint).  In a data-parallel run a given state must be the
        same on every rank (parallel/mesh.py::replicate_state); rank 0
        writes the trace."""
        cfg = self.cfg
        resumed = self.resume_epoch()
        state = state if state is not None else self.init_state()
        total_steps = 0
        first_epoch = (resumed + 1 if resumed is not None
                       else cfg.epoch_count)
        last_epoch = cfg.niter + cfg.niter_decay
        if stop_epoch is not None:
            last_epoch = min(last_epoch, stop_epoch)
        with trace(profile_dir if self.primary else None):
            for epoch in range(first_epoch, last_epoch + 1):
                state, train_loss, total_steps = self.train_epoch(
                    state, epoch, total_steps)
                if epoch % cfg.save_epoch_freq == 0:
                    self.ckpt.save(epoch, state)
                valid_loss = self.validate(state)
                self.logger.log_epoch(epoch, train_loss, valid_loss)

                check = valid_loss if np.isfinite(valid_loss) else train_loss
                if self.early(check):
                    if self.primary:
                        print("Early stopping")
                    break
                # the reference steps its schedulers once an epoch
                if self.plateau is not None:
                    new_lr = self.plateau.step(check)
                else:
                    new_lr = lr_for_epoch(cfg, epoch)
                set_learning_rate(state, new_lr)
        self.logger.save_loss_plot()
        self.logger.close()
        # the last epoch's write may still be in flight: a fresh manager
        # listing the directory must find it
        self.ckpt.wait()
        return state
