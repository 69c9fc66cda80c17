"""Rematerialisation of U-Net levels (Config.remat / remat_depth), the
counterpart of nn.remat in the JAX package's U-Nets.

A checkpointed level keeps no activations for the backward: autograd runs
the level's forward again when it needs them (torch.utils.checkpoint,
non-reentrant, so the first forward keeps grad mode on and the attention
Function builds its matrix as it does without remat).  The level's
submodule call sits inside it, so a checkpointed level recomputes its whole
subtree.  Two things that flax's functional state gives for free are done
here by hand:

  * dropout draws from an explicit torch.Generator, which checkpoint does
    not replay: the generator's state at the level's entry is set again for
    the recompute, and put back where the step left it afterwards;
  * a recomputed train-mode BatchNorm would move its running statistics a
    second time: the recompute runs under frozen_running_stats;
  * the conv modes (ops/convs.py), the process group of a data-parallel
    step and the spatial context of a spatially partitioned one
    (parallel/collectives.py) are held per thread, and autograd may run
    the backward, and with it the recompute, in a thread of its own: the
    modes, the group and the spatial context in force when the level is
    called are entered again for the recompute, which then takes the
    forward's conv paths, the global batch's BatchNorm moments and the
    same slabs and exchanges of rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.convs import current_modes, frozen_running_stats, use_modes
from ..parallel.collectives import (current_group, current_spatial,
                                    use_group, use_spatial)
from ..utils.profiling import span


def mark_levels(outermost: nn.Module, remat: bool, depth: int) -> None:
    """Number a U-Net's levels from the outside (the outermost block is 0,
    each `submodule` one more) and set `remat` on the `depth` outermost
    ones (0 = all), as the JAX package's setup numbers them."""
    level, block = 0, outermost
    while block is not None:
        block.remat = remat and (depth == 0 or level < depth)
        level, block = level + 1, block.submodule


def checkpoint_level(level: nn.Module, fn: Callable, x: torch.Tensor,
                     generator: Optional[torch.Generator]):
    """fn(x), the forward of `level`, without keeping its activations.
    `generator` is the dropout's (None: the device's default generator,
    which checkpoint itself replays)."""
    entry = None if generator is None else generator.get_state()
    modes, group, spatial = current_modes(), current_group(), \
        current_spatial()
    calls = 0

    def run(x):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(x)
        # the recompute: the same dropout draw, conv modes, group and
        # spatial context, no running-statistics move
        left = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(entry)
        try:
            with span("dip.remat.recompute"), frozen_running_stats(level), \
                    use_modes(modes), use_group(group), use_spatial(spatial):
                return fn(x)
        finally:
            if generator is not None:
                generator.set_state(left)

    return checkpoint(run, x, use_reentrant=False)
