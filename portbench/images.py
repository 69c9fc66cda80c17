"""Seeded inputs of the benchmark, made on the device in a few large calls.

A copy of the scene and hole generators of the synthetic training set
(smooth gradient, 2-5 solid ellipses or rotated bars composited in turn, a
periodic texture, a little noise; a hole of one rectangle of 0.2-0.4 of the
side plus 1-3 thick strokes), with the same distributions, drawn for many
images at once from a torch.Generator on the device.  The program takes
these as uint8 host arrays, as its data loader yields them.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MAX_SHAPES = 5
MAX_STROKES = 3
CHUNK = 32                 # images drawn in one call


def _u(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def _int(gen, shape, lo, hi):
    """Integers in [lo, hi) (hi a tensor or a number)."""
    return (lo + torch.floor(torch.rand(shape, generator=gen,
                                        device=gen.device) * (hi - lo)))


def _images(gen, n: int, size: int) -> torch.Tensor:
    """n scenes, uint8 [n, size, size, 3]."""
    dev = gen.device
    side = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = torch.meshgrid(side, side, indexing="ij")
    c0 = _u(gen, (n, 1, 1, 3), 0.1, 0.9)
    c1 = _u(gen, (n, 1, 1, 3), 0.1, 0.9)
    ang = _u(gen, (n, 1, 1), 0.0, 2 * math.pi)
    t = ((torch.cos(ang) * xx + torch.sin(ang) * yy) / size + 1.0) / 2.0
    img = c0 * (1 - t[..., None]) + c1 * t[..., None]
    count = _int(gen, (n,), 2, 6)
    color = _u(gen, (n, MAX_SHAPES, 3), 0.0, 1.0)
    centre = _u(gen, (n, MAX_SHAPES, 2), 0.15, 0.85) * size
    ellipse = torch.rand((n, MAX_SHAPES), generator=gen, device=dev) < 0.5
    radii = _u(gen, (n, MAX_SHAPES, 2), 0.06, 0.25) * size
    half = _u(gen, (n, MAX_SHAPES, 2), 0.05, 0.3) * size
    rot = _u(gen, (n, MAX_SHAPES), 0.0, math.pi)
    for s in range(MAX_SHAPES):
        dx = xx - centre[:, s, 0, None, None]
        dy = yy - centre[:, s, 1, None, None]
        in_ellipse = ((dx / radii[:, s, 0, None, None]) ** 2
                      + (dy / radii[:, s, 1, None, None]) ** 2) <= 1.0
        ca = torch.cos(rot[:, s])[:, None, None]
        sa = torch.sin(rot[:, s])[:, None, None]
        u, v = dx * ca + dy * sa, -dx * sa + dy * ca
        in_bar = ((u.abs() <= half[:, s, 0, None, None])
                  & (v.abs() <= half[:, s, 1, None, None]))
        m = torch.where(ellipse[:, s, None, None], in_ellipse, in_bar)
        m = m & (s < count)[:, None, None]
        blend = 0.7 * color[:, s, None, None, :] + 0.3 * img
        img = torch.where(m[..., None], blend, img)
    freq = _u(gen, (n, 2), 2.0, 14.0)
    phase = _u(gen, (n, 2), 0.0, 2 * math.pi)
    wave = lambda k, t: torch.sin(2 * math.pi * freq[:, k, None, None] * t
                                  / size + phase[:, k, None, None])
    tex = 0.5 + 0.5 * wave(0, xx) * wave(1, yy)
    img = torch.clamp(img + (tex * _u(gen, (n, 1, 1), 0.05, 0.25))[..., None],
                      0, 1)
    img = img + 0.01 * torch.randn(img.shape, generator=gen, device=dev)
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8)


def _masks(gen, n: int, size: int) -> torch.Tensor:
    """n holes, uint8 [n, size, size], 255 = hole."""
    dev = gen.device
    side = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = torch.meshgrid(side, side, indexing="ij")
    wh = torch.floor(_u(gen, (n, 2), 0.2, 0.4) * size)
    lo = size // 8
    x0 = _int(gen, (n,), lo, size - wh[:, 0] - lo)
    y0 = _int(gen, (n,), lo, size - wh[:, 1] - lo)
    x1, y1 = x0 + wh[:, 0], y0 + wh[:, 1]
    hole = ((xx >= x0[:, None, None]) & (xx < x1[:, None, None])
            & (yy >= y0[:, None, None]) & (yy < y1[:, None, None]))
    strokes = _int(gen, (n,), 1, 4)
    p0 = _u(gen, (n, MAX_STROKES, 2), 0.1, 0.9) * size
    d = _u(gen, (n, MAX_STROKES, 2), -1.0, 1.0)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    length = _u(gen, (n, MAX_STROKES), 0.2, 0.5) * size
    thick = _u(gen, (n, MAX_STROKES), 0.02, 0.05) * size
    for s in range(MAX_STROKES):
        rx = xx - p0[:, s, 0, None, None]
        ry = yy - p0[:, s, 1, None, None]
        u = rx * d[:, s, 0, None, None] + ry * d[:, s, 1, None, None]
        v = (rx * d[:, s, 1, None, None] - ry * d[:, s, 0, None, None]).abs()
        m = ((u >= 0) & (u <= length[:, s, None, None])
             & (v <= thick[:, s, None, None]) & (s < strokes)[:, None, None])
        hole = hole | m
    return hole.to(torch.uint8) * 255


def pool(seed: int, n: int, size: int, device) -> Dict[str, np.ndarray]:
    """n images and n holes from `seed`, as host arrays: {'image': uint8
    [n,H,W,3], 'mask': uint8 [n,H,W] (255 = hole)}.  The same seed gives
    the same arrays on the same device type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    images = torch.empty((n, size, size, 3), dtype=torch.uint8)
    masks = torch.empty((n, size, size), dtype=torch.uint8)
    for lo in range(0, n, CHUNK):
        k = min(CHUNK, n - lo)
        images[lo:lo + k] = _images(gen, k, size).cpu()
        masks[lo:lo + k] = _masks(gen, k, size).cpu()
    return {"image": images.numpy(), "mask": masks.numpy()}


def ref_index(n: int) -> np.ndarray:
    """The reference image of request i: another image of the pool, the
    one n/2 places further on (a different scene for n >= 2)."""
    return (np.arange(n) + n // 2) % n
