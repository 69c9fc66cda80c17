"""VGG16 four-slice feature extractor (counterpart of
deepinpainting_tpu/models/vgg16.py), NCHW.

torchvision vgg16 `features` split at indices 5/10/17/23.  The slices
include the max-pools, so the returned "relu" names are post-pool
activations except the last:

    relu1_2 = pool1 output,  64ch, H/2
    relu2_2 = pool2 output, 128ch, H/4
    relu3_3 = pool3 output, 256ch, H/8
    relu4_3 = conv4_3+ReLU, 512ch, H/8   (attention ref)

Inputs are [-1,1] images, not ImageNet-normalised.  The extractor is frozen.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convs import he_normal_


class VggFeatures(NamedTuple):
    relu1_2: torch.Tensor
    relu2_2: torch.Tensor
    relu3_3: torch.Tensor
    relu4_3: torch.Tensor


# (name, out_channels) per conv, grouped into the four slices.
SLICES = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
)


class Vgg16(nn.Module):
    """width_scale != 1 shrinks every channel count (scaled-down test
    configs only).  Convs are attributes named conv1_1 ... conv4_3."""

    def __init__(self, width_scale: float = 1.0):
        super().__init__()
        cin = 3
        for convs in SLICES:
            for name, c in convs:
                cout = max(1, int(c * width_scale))
                setattr(self, name, nn.Conv2d(cin, cout, 3, 1, 1))
                cin = cout
        self.requires_grad_(False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """he_normal kernels and zero biases, as the JAX package's init."""
        for convs in SLICES:
            for name, _ in convs:
                conv = getattr(self, name)
                he_normal_(conv.weight, generator)
                nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> VggFeatures:
        feats = []
        y = x
        for si, convs in enumerate(SLICES):
            for name, _ in convs:
                y = F.relu(getattr(self, name)(y))
            if si < 3:
                y = F.max_pool2d(y, 2)   # slices 1-3 end in their pool
            feats.append(y)
        return VggFeatures(*feats)
