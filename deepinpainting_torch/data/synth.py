"""A self-contained synthetic inpainting dataset (the port's copy of the
JAX repository's make_synth_data.py, which the recorded protocols
trained on; the same arguments write the same files, byte for byte).

Structured scenes, which a two-stage inpainter can learn to complete:
smooth gradient backgrounds, solid geometric shapes, periodic textures,
a little noise.  Holes are one central-ish rectangle plus a few thick
strokes, 10-30% of the frame.

Layout written under `out`:
  img/NNNN.jpg    train images        mask/NNNN.png  hole masks (255=hole)
  valid/NNNN.jpg  held-out images     (refs: img/ or valid/ as refroot; the
                                       model is self-reference-guided in
                                       the eval path)

    python -m deepinpainting_torch.data.synth --out /tmp/synth --n 300 \
        --size 256

numpy and PIL only (the data package is imported by loader workers).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image


def _gradient(rng, size):
    c0 = rng.uniform(0.1, 0.9, 3)
    c1 = rng.uniform(0.1, 0.9, 3)
    ang = rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:size, 0:size] / size
    t = (np.cos(ang) * xx + np.sin(ang) * yy + 1.0) / 2.0
    return c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]


def _texture(rng, size):
    fx, fy = rng.uniform(2, 14, 2)
    ph = rng.uniform(0, 2 * np.pi, 2)
    yy, xx = np.mgrid[0:size, 0:size] / size
    tex = 0.5 + 0.5 * np.sin(2 * np.pi * fx * xx + ph[0]) * \
        np.sin(2 * np.pi * fy * yy + ph[1])
    return tex[..., None] * rng.uniform(0.05, 0.25)


def _shapes(rng, img, size):
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(rng.integers(2, 6)):
        color = rng.uniform(0, 1, 3)
        cx, cy = rng.uniform(0.15, 0.85, 2) * size
        if rng.random() < 0.5:  # ellipse
            rx, ry = rng.uniform(0.06, 0.25, 2) * size
            m = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
        else:  # rotated bar
            w, h = rng.uniform(0.05, 0.3, 2) * size
            a = rng.uniform(0, np.pi)
            u = (xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)
            v = -(xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)
            m = (np.abs(u) <= w) & (np.abs(v) <= h)
        img[m] = 0.7 * color + 0.3 * img[m]
    return img


def make_image(rng, size: int) -> np.ndarray:
    """One [size, size, 3] uint8 scene."""
    img = _gradient(rng, size)
    img = _shapes(rng, img, size)
    img = np.clip(img + _texture(rng, size), 0, 1)
    img += rng.normal(0, 0.01, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_mask(rng, size: int) -> np.ndarray:
    """One [size, size] uint8 hole mask (255 = hole): a rectangle of
    0.2-0.4 of the side, plus 1-3 strokes."""
    m = np.zeros((size, size), np.uint8)
    w, h = (rng.uniform(0.2, 0.4, 2) * size).astype(int)
    x0 = rng.integers(size // 8, size - w - size // 8)
    y0 = rng.integers(size // 8, size - h - size // 8)
    m[y0:y0 + h, x0:x0 + w] = 255
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(rng.integers(1, 4)):
        p0 = rng.uniform(0.1, 0.9, 2) * size
        d = rng.uniform(-1, 1, 2)
        d /= np.linalg.norm(d) + 1e-8
        ln = rng.uniform(0.2, 0.5) * size
        th = rng.uniform(0.02, 0.05) * size
        u = (xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]
        v = np.abs((xx - p0[0]) * d[1] - (yy - p0[1]) * d[0])
        m[(u >= 0) & (u <= ln) & (v <= th)] = 255
    return m


def write(out: str, n: int = 300, n_valid: int = 32, n_masks: int = 64,
          size: int = 256, seed: int = 0) -> None:
    """The dataset under `out`: the train images, then the held-out ones,
    then the masks, from one numpy Generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    for sub in ("img", "valid", "mask"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    for i in range(n):
        Image.fromarray(make_image(rng, size)).save(
            os.path.join(out, "img", f"{i:04d}.jpg"), quality=95)
    for i in range(n_valid):
        Image.fromarray(make_image(rng, size)).save(
            os.path.join(out, "valid", f"{i:04d}.jpg"), quality=95)
    for i in range(n_masks):
        Image.fromarray(make_mask(rng, size)).save(
            os.path.join(out, "mask", f"{i:04d}.png"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=300, help="train images")
    ap.add_argument("--n_valid", type=int, default=32)
    ap.add_argument("--n_masks", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    write(args.out, args.n, args.n_valid, args.n_masks, args.size, args.seed)
    print(f"wrote {args.n} train + {args.n_valid} valid images, "
          f"{args.n_masks} masks under {args.out}")


if __name__ == "__main__":
    main()
