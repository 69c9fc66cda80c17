"""Discriminators: the image PatchGAN netD and the VGG-feature PatchGAN
netF (counterpart of deepinpainting_tpu/models/discriminators.py), NCHW.

  * NLayerDiscriminator: n_layers=3, 70x70 receptive field.  Conv4x4 s2
    (input_nc -> ndf) -> LeakyReLU; two Conv4x4 s2 -> InstanceNorm ->
    LeakyReLU doubling the width; one Conv4x4 s1 -> InstanceNorm ->
    LeakyReLU to 8*ndf; a Conv4x4 s1 head to one channel; sigmoid when
    gan_type is 'vanilla'.  With InstanceNorm every conv keeps its bias;
    with norm='batch' the convs that feed a BatchNorm have none (the first
    conv and the head always keep theirs).
  * PFDiscriminator: three Conv4x4 s2 layers on VGG relu3_3 features; the
    middle one is followed by an InstanceNorm without affine parameters.

Layer attribute names follow the JAX package's flax scope names (`conv0`,
`norm1`, `head`), so the weight bridge resolves each key by its path.  The
convs are ops/convs.py's, so the conv modes reach them as they reach the
JAX package's TorchConv (pack_small_cin rewrites netD's 3-channel conv0).

Under spatial partitioning (parallel/spatial.py) both run whole on every
rank: netD takes the gathered image (its k4 s1 tail gives heights, 31 and
30 at 256 px, that split over no slab count; the JAX package keeps it
batch-only under norm='batch' for the same reason), and netF takes VGG's
features, which are whole already.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import Conv2d, leaky_relu, make_norm
from ..parallel.collectives import full_rows, replicated


class NLayerDiscriminator(nn.Module):
    """PatchGAN on images: [B, input_nc, H, W] -> [B, 1, h, w] patch
    scores."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, norm: str = "instance"):
        super().__init__()
        use_bias = norm == "instance"
        self.n_layers = n_layers
        self.use_sigmoid = use_sigmoid
        self.conv0 = Conv2d(input_nc, ndf, 4, 2, 1)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv{n}", Conv2d(cin, cout, 4, stride, 1,
                                             bias=use_bias))
            setattr(self, f"norm{n}", make_norm(norm, cout))
            cin = cout
        self.head = Conv2d(cin, 1, 4, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = full_rows(x)
        with replicated():
            y = leaky_relu(self.conv0(x), 0.2)
            for n in range(1, self.n_layers + 1):
                y = getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(y))
                y = leaky_relu(y, 0.2)
            y = self.head(y)
        return torch.sigmoid(y) if self.use_sigmoid else y


class PFDiscriminator(nn.Module):
    """Feature PatchGAN on VGG relu3_3 features: [B, in_channels, h, w] ->
    [B, width, h/8, w/8].  Widths other than 256 -> 512 serve scaled-down
    test configs only."""

    def __init__(self, in_channels: int = 256, width: int = 512):
        super().__init__()
        self.conv0 = Conv2d(in_channels, width, 4, 2, 1)
        self.conv1 = Conv2d(width, width, 4, 2, 1)
        self.conv2 = Conv2d(width, width, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with replicated():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        # Three 4x4 s2 p1 convs need an 8x8 input to emit one patch; a
        # smaller map (configs under 64 px) is zero-padded at the bottom
        # and right up to that minimum, as the JAX package pads it.
        pad_h = max(0, 8 - x.shape[2])
        pad_w = max(0, 8 - x.shape[3])
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h))
        y = leaky_relu(self.conv0(x), 0.2)
        y = self.conv1(y)
        # InstanceNorm without affine parameters: normalise only
        mean = y.mean(dim=(2, 3), keepdim=True)
        var = (y - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (y - mean) / torch.sqrt(var + 1e-5)
        return self.conv2(leaky_relu(y, 0.2))
