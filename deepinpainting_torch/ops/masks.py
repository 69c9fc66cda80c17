"""Mask math on tensors (counterpart of deepinpainting_tpu/ops/masks.py).

Masks are float tensors with 1.0 = hole, layout [..., H, W].  Images are
NCHW here ([..., 3, H, W]), the torch habit; the JAX package keeps NHWC.
Every value is a 0/1 mask or a dyadic fraction of one, so the window sums
below are exact and the results equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Per-channel fill constants for the hole: 2*mean/255 - 1 on [-1,1] images
# (ImageNet means 123/104/117).
HOLE_FILL_RGB = (2 * 123.0 / 255.0 - 1.0,
                 2 * 104.0 / 255.0 - 1.0,
                 2 * 117.0 / 255.0 - 1.0)


def center_mask(fine_size: int, overlap: int = 4,
                device=None) -> torch.Tensor:
    """Square center mask, hole = 1: rows and columns in
    [N/4 + overlap, 3N/4 - overlap).  float32 [fine_size, fine_size]."""
    lo = fine_size // 4 + overlap
    hi = fine_size // 2 + fine_size // 4 - overlap
    r = torch.arange(fine_size, device=device)
    band = (r >= lo) & (r < hi)
    return (band[:, None] & band[None, :]).to(torch.float32)


def feat_mask(mask: torch.Tensor, layers: int = 3,
              threshold: float = 5.0 / 16.0) -> torch.Tensor:
    """Full-res mask -> binarized feature-resolution mask.

    `layers` stacked 4x4/stride-2/pad-1 window sums scaled by 1/16 (zero
    padding contributes zeros), then a strict `>`.  mask: [..., H, W].
    Returns float32 [..., H/2^layers, W/2^layers] in {0, 1}.
    """
    lead = mask.shape[:-2]
    x = mask.to(torch.float32).reshape(-1, 1, *mask.shape[-2:])
    for _ in range(layers):
        x = F.avg_pool2d(x, 4, 2, 1, divisor_override=1) * (1.0 / 16.0)
    return (x > threshold).to(torch.float32).reshape(*lead, *x.shape[-2:])


def patch_flags(fmask: torch.Tensor, patch_size: int = 1, stride: int = 1,
                mask_thred: float = 1.0) -> torch.Tensor:
    """Per-patch masked flags: a patch is masked iff the mask sum inside its
    window is >= mask_thred.  fmask: [..., h, w].  Returns float32
    [..., nH*nW] in raster order, nH = (h - patch_size)//stride + 1."""
    if patch_size == 1 and stride == 1:
        sums = fmask
    else:
        lead = fmask.shape[:-2]
        x = fmask.to(torch.float32).reshape(-1, 1, *fmask.shape[-2:])
        sums = F.avg_pool2d(x, patch_size, stride, divisor_override=1)
        sums = sums.reshape(*lead, *sums.shape[-2:])
    return (sums >= mask_thred).to(torch.float32).flatten(-2)


def expand_mask(mask: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """[..., H, W] -> [..., C, H, W] broadcast."""
    return mask.unsqueeze(-3).expand(*mask.shape[:-2], channels,
                                     *mask.shape[-2:])


def fill_hole_with_mean(image: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Replace the hole with the fixed per-channel constants.
    image: [..., 3, H, W] in [-1, 1]; mask: [..., H, W], 1 = hole."""
    fill = torch.tensor(HOLE_FILL_RGB, dtype=image.dtype,
                        device=image.device)[:, None, None]
    m = mask.unsqueeze(-3)
    return image * (1.0 - m) + fill * m


def zero_hole(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out the hole region.  image [..., C, H, W]; mask [..., H, W]."""
    return image * (1.0 - mask.unsqueeze(-3))


def draw_strokes(generator: torch.Generator, num_strokes: int = 8):
    """The random draws of random_stroke_mask, from `generator` (on its
    device), in the JAX package's ranges: starts [S, 2] in [0.1, 0.9],
    deltas [S, 2] in [-1, 1], lengths [S, 1] in [0.2, 1], all f32.  torch
    cannot draw jax.random's numbers, so only these ranges are shared."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return lo + (hi - lo) * u
    return (uniform((num_strokes, 2), 0.1, 0.9),
            uniform((num_strokes, 2), -1.0, 1.0),
            uniform((num_strokes, 1), 0.2, 1.0))


def render_strokes(starts: torch.Tensor, deltas: torch.Tensor,
                   lengths: torch.Tensor, fine_size: int, max_len: int = 48,
                   thickness: int = 8, device=None) -> torch.Tensor:
    """Thick line segments on a [fine_size, fine_size] grid: each stroke
    runs from its start along its normalised delta for length * max_len
    pixels (the end clipped to the image), and a pixel is a hole where its
    distance to the nearest segment is at most thickness / 2 pixels, all in
    [0, 1] image coordinates on a linspace grid, as the JAX package renders
    them.  float32 [fine_size, fine_size], 1 = hole."""
    starts, deltas, lengths = (t.to(device=device, dtype=torch.float32)
                               for t in (starts, deltas, lengths))
    deltas = deltas / (deltas.square().sum(-1, keepdim=True).sqrt() + 1e-8)
    ends = torch.clamp(starts + deltas * lengths * (max_len / fine_size),
                       0.0, 1.0)
    yy = torch.arange(fine_size, dtype=torch.float32,
                      device=starts.device) / (fine_size - 1)
    grid = torch.stack(torch.meshgrid(yy, yy, indexing="ij"), dim=-1)
    p0, d = starts[:, None, None, :], (ends - starts)[:, None, None, :]
    rel = grid - p0                                        # [S, H, W, 2]
    denom = (d * d).sum(-1) + 1e-12
    t = torch.clamp((rel * d).sum(-1) / denom, 0.0, 1.0)
    off = grid - (p0 + t[..., None] * d)
    dists = off.square().sum(-1).sqrt()
    radius = thickness / (2.0 * fine_size)
    return (dists.amin(dim=0) <= radius).to(torch.float32)


def random_stroke_mask(generator: torch.Generator, fine_size: int,
                       num_strokes: int = 8, max_len: int = 48,
                       thickness: int = 8) -> torch.Tensor:
    """Free-form stroke mask on `generator`'s device: render_strokes of
    draw_strokes.  float32 [fine_size, fine_size], 1 = hole."""
    return render_strokes(*draw_strokes(generator, num_strokes), fine_size,
                          max_len, thickness, generator.device)
