"""Rough-stage U-Net generator netP, pix2pix `unet_256` (counterpart of
deepinpainting_tpu/models/unet.py), NCHW.

Down = LeakyReLU(0.2) -> Conv4x4 s2 p1 -> InstanceNorm; up = ReLU ->
ConvT4x4 s2 p1 -> InstanceNorm; the outermost level ends in tanh; skips are
channel concats [up(x), x], a size mismatch fixed by bilinear resize.
Layer attribute names follow the JAX package's flax scope names, and the
nested blocks are `model.submodule.submodule...`, as flax names them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import InstanceNorm, bilinear_resize, leaky_relu


class UnetSkipBlock(nn.Module):
    """One skip level of the rough U-Net."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None,
                 outermost: bool = False, innermost: bool = False,
                 use_dropout: bool = False):
        super().__init__()
        input_nc = outer_nc if input_nc is None else input_nc
        self.outermost, self.innermost = outermost, innermost
        self.down_conv = nn.Conv2d(input_nc, inner_nc, 4, 2, 1)
        if not (outermost or innermost):
            self.down_norm = InstanceNorm(inner_nc)
        self.submodule = submodule
        up_in = inner_nc if innermost else 2 * inner_nc
        self.up_conv = nn.ConvTranspose2d(up_in, outer_nc, 4, 2, 1)
        if not outermost:
            self.up_norm = InstanceNorm(outer_nc)
        self.dropout = (nn.Dropout(0.5) if use_dropout and not outermost
                        else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.outermost else leaky_relu(x, 0.2)
        y = self.down_conv(y)
        if not (self.outermost or self.innermost):
            y = self.down_norm(y)
        if self.submodule is not None:
            y = self.submodule(y)
        y = self.up_conv(F.relu(y))
        if self.outermost:
            return torch.tanh(y)
        y = self.up_norm(y)
        if self.dropout is not None:
            y = self.dropout(y)
        if y.shape[2:] != x.shape[2:]:
            y = bilinear_resize(y, x.shape[2], x.shape[3])
        return torch.cat([y, x], dim=1)


class UnetGenerator(nn.Module):
    """`unet_256` rough generator: num_downs levels, channels
    ngf -> 2ngf -> 4ngf -> 8ngf x (num_downs - 3)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64,
                 use_dropout: bool = False):
        super().__init__()
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block,
                                  use_dropout=use_dropout)
        block = UnetSkipBlock(ngf * 4, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 2, ngf * 4, submodule=block)
        block = UnetSkipBlock(ngf, ngf * 2, submodule=block)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc,
                                   submodule=block, outermost=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, input_nc, H, W] in [-1, 1] -> [B, output_nc, H, W]."""
        return self.model(x)
