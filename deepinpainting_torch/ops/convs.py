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
InstanceNorm affine at (1, 0).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


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
