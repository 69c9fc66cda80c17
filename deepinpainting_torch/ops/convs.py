"""Layers at PyTorch geometry (counterpart of deepinpainting_tpu/ops/convs.py).

The JAX package emulates torch's Conv2d/ConvTranspose2d geometry on NHWC;
here they are the native layers on NCHW:

  * Conv2d k4 s2 p1              — halving downsample (netP)
  * Conv2d k4 s2 p3 d2 (dilated) — halving downsample, keeps channels (netG)
  * Conv2d k3 s1 p1              — same-size
  * ConvTranspose2d k4 s2 p1     — doubling upsample
  * ConvTranspose2d k3 s1 p1     — same-size

Weight init draws the same distributions as the JAX package's make_init
(not the same bits: torch and JAX generators differ).  Biases start at 0,
InstanceNorm affine at (1, 0), BatchNorm scale from N(1, gain).  `Dropout`
draws its keep mask from an explicit torch.Generator, so a training run
repeats from a seed.

Compute dtype (Config.dtype): parameters stay f32 and every layer computes
in its input's dtype, as the JAX package's layers do.  Under bf16 a conv
casts its weight to bf16 per call (its gradient reaches the f32 master
weight through the cast), its output is rounded to bf16 and the bias is
added in bf16; the norms keep their statistics in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
NORMS = ("instance", "batch")


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=True): biased variance over H, W per (N, C),
    statistics in f32.  x: [N, C, H, W]."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) with the JAX package's arithmetic."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.eps)


def _channels(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A per-channel vector [C] in `dtype`, shaped to broadcast on NCHW."""
    return v.to(dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype (see the module
    docstring); on an f32 input it is nn.Conv2d unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y if self.bias is None else y + _channels(self.bias, x.dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (output_padding 0) that computes in its input's
    dtype, as Conv2d does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride,
                               self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y if self.bias is None else y + _channels(self.bias, x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d at its defaults (eps 1e-5, momentum 0.1), which is
    what the JAX package's TorchBatchNorm reproduces: train mode normalises
    with the biased batch variance over (N, H, W) and tracks the unbiased
    one, eval mode uses the running statistics.

    On an input in another dtype than f32 the statistics and the
    normalisation run in f32, the result is cast back, and the scale and
    offset apply in the input's dtype (TorchBatchNorm's arithmetic; a bare
    nn.BatchNorm2d applies them in f32).  Inside frozen_running_stats a
    train-mode forward normalises by its batch as usual but leaves the
    running statistics where they were."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if self.training and self.frozen:
            # copies take the update; passing none would change what the
            # forward saves for the backward, which checkpoint compares
            mean, var = mean.clone(), var.clone()
        elif self.training:
            self.num_batches_tracked.add_(1)
        if x.dtype == self.weight.dtype:
            return F.batch_norm(x, mean, var, self.weight, self.bias,
                                self.training, self.momentum, self.eps)
        y = F.batch_norm(x.to(self.weight.dtype), mean, var, None, None,
                         self.training, self.momentum, self.eps).to(x.dtype)
        return (y * _channels(self.weight, x.dtype)
                + _channels(self.bias, x.dtype))


@contextlib.contextmanager
def frozen_running_stats(*modules: nn.Module):
    """Within the block, the BatchNorm layers of `modules` do not move
    their running statistics: for forwards that repeat one whose update was
    already taken (a rematerialised block's recompute, the G phase of a
    gradient-accumulated step).  Nests; each layer gets its flag back."""
    layers = [m for mod in modules for m in mod.modules()
              if isinstance(m, BatchNorm)]
    before = [m.frozen for m in layers]
    for m in layers:
        m.frozen = True
    try:
        yield
    finally:
        for m, flag in zip(layers, before):
            m.frozen = flag


def make_norm(norm: str, channels: int) -> nn.Module:
    """Norm-layer factory (Config.norm): 'instance' is InstanceNorm above,
    'batch' is BatchNorm."""
    if norm == "instance":
        return InstanceNorm(channels)
    if norm == "batch":
        return BatchNorm(channels)
    raise NotImplementedError(
        f"normalization layer [{norm}] is not found (supported: "
        f"{', '.join(NORMS)})")


class Dropout(nn.Module):
    """Inverted dropout, active in train mode only: each element is kept
    with probability 1 - p and scaled by 1 / (1 - p).  The keep mask comes
    from `generator`, a torch.Generator on x's device (nn.Dropout takes
    none); None draws from that device's default generator."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= self.p
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.p))


def bilinear_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(method='bilinear') on NCHW: half-pixel centres
    (align_corners=False) with a widened triangle kernel when shrinking
    (antialias).  Used only where a skip connection's size mismatches."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def init_weight_(weight: torch.Tensor, init_type: str, gain: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Fill a conv / conv-transpose weight in place (torch layout).

    torch's fan convention holds for both layouts: fan_in = size(1)*kh*kw,
    fan_out = size(0)*kh*kw.
      * normal:     N(0, gain)
      * xavier:     N(0, gain*sqrt(2/(fan_in+fan_out)))
      * kaiming:    N(0, sqrt(2/fan_in))
      * orthogonal: rows of the [size(0), rest] matrix orthonormal, * gain
    """
    shape = weight.shape
    rf = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * rf, shape[0] * rf
    draw = lambda s: torch.randn(s, generator=generator, dtype=torch.float32)
    if init_type == "normal":
        w = gain * draw(shape)
    elif init_type == "xavier":
        w = gain * math.sqrt(2.0 / (fan_in + fan_out)) * draw(shape)
    elif init_type == "kaiming":
        w = math.sqrt(2.0 / fan_in) * draw(shape)
    elif init_type == "orthogonal":
        rows, cols = shape[0], weight.numel() // shape[0]
        big, small = max(rows, cols), min(rows, cols)
        q, r = torch.linalg.qr(draw((big, small)))
        q = q * torch.sign(torch.diagonal(r))   # Haar-uniform sign fix
        m = q.T if rows < cols else q           # [rows, cols]
        w = gain * m.reshape(shape)
    else:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    with torch.no_grad():
        weight.copy_(w)
    return weight


def he_normal_(weight: torch.Tensor, generator: torch.Generator
               ) -> torch.Tensor:
    """flax he_normal: truncated normal at +-2 std, variance 2/fan_in."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    w = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w)
    return weight
