"""Rough-stage U-Net generator netP, pix2pix `unet_256` (counterpart of
deepinpainting_tpu/models/unet.py), NCHW.

Down = LeakyReLU(0.2) -> Conv4x4 s2 p1 -> norm; up = ReLU ->
ConvT4x4 s2 p1 -> norm (InstanceNorm, or BatchNorm with norm='batch'); the
outermost level ends in tanh; skips are channel concats [up(x), x], a size
mismatch fixed by bilinear resize.
Layer attribute names follow the JAX package's flax scope names, and the
nested blocks are `model.submodule.submodule...`, as flax names them.
Dropout(0.5) sits in the middle 8ngf blocks when use_dropout is set; it is
active in train mode only and draws from the generator passed to forward.
With remat the `remat_depth` outermost levels (0 = all; the innermost is
level num_downs - 1) are checkpointed under grad (models/remat.py).  Every
layer computes in its input's dtype (ops/convs.py).

Under spatial partitioning (parallel/spatial.py) a level runs on its
slab of rows unless its k4 s2 down conv cannot (an odd slab, as the
bottleneck's 1-row slabs): that level, and with it every level inside it,
runs on the gathered image and hands back its slab, where the JAX package
pins such a height to a batch-only sharding (constrain_unshardable_spatial).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import (Conv2d, ConvTranspose2d, Dropout, bilinear_resize,
                         leaky_relu, make_norm)
from ..parallel.collectives import (full_rows, must_gather, own_rows,
                                    replicated)
from .remat import checkpoint_level, mark_levels


class UnetSkipBlock(nn.Module):
    """One skip level of the rough U-Net."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None,
                 outermost: bool = False, innermost: bool = False,
                 use_dropout: bool = False, norm: str = "instance"):
        super().__init__()
        input_nc = outer_nc if input_nc is None else input_nc
        self.outermost, self.innermost = outermost, innermost
        self.down_conv = Conv2d(input_nc, inner_nc, 4, 2, 1)
        if not (outermost or innermost):
            self.down_norm = make_norm(norm, inner_nc)
        self.submodule = submodule
        up_in = inner_nc if innermost else 2 * inner_nc
        self.up_conv = ConvTranspose2d(up_in, outer_nc, 4, 2, 1)
        if not outermost:
            self.up_norm = make_norm(norm, outer_nc)
        self.dropout = (Dropout(0.5) if use_dropout and not outermost
                        else None)
        self.remat = False          # set by UnetGenerator (mark_levels)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if must_gather(x.shape[2], 2, 1):
            full = full_rows(x)
            with replicated():
                y = self.forward(full, generator)
            return own_rows(y)
        if self.remat and torch.is_grad_enabled():
            return checkpoint_level(
                self, lambda t: self._forward(t, generator), x, generator)
        return self._forward(x, generator)

    def _forward(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        y = x if self.outermost else leaky_relu(x, 0.2)
        y = self.down_conv(y)
        if not (self.outermost or self.innermost):
            y = self.down_norm(y)
        if self.submodule is not None:
            y = self.submodule(y, generator)
        y = self.up_conv(F.relu(y))
        if self.outermost:
            return torch.tanh(y)
        y = self.up_norm(y)
        if self.dropout is not None:
            y = self.dropout(y, generator)
        if y.shape[2:] != x.shape[2:]:
            y = bilinear_resize(y, x.shape[2], x.shape[3])
        return torch.cat([y, x], dim=1)


class UnetGenerator(nn.Module):
    """`unet_256` rough generator: num_downs levels, channels
    ngf -> 2ngf -> 4ngf -> 8ngf x (num_downs - 3)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64,
                 use_dropout: bool = False, norm: str = "instance",
                 remat: bool = False, remat_depth: int = 1):
        super().__init__()
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block,
                                  use_dropout=use_dropout, norm=norm)
        block = UnetSkipBlock(ngf * 4, ngf * 8, submodule=block, norm=norm)
        block = UnetSkipBlock(ngf * 2, ngf * 4, submodule=block, norm=norm)
        block = UnetSkipBlock(ngf, ngf * 2, submodule=block, norm=norm)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc,
                                   submodule=block, outermost=True,
                                   norm=norm)
        mark_levels(self.model, remat, remat_depth)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, input_nc, H, W] in [-1, 1] -> [B, output_nc, H, W].
        generator: the dropout's, used in train mode only."""
        return self.model(x, generator)
