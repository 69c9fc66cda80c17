"""Host-side image IO and visualization helpers (the port's own copy of
deepinpainting_tpu/utils/imaging.py; numpy and PIL only).

Capability parity with the reference's util/util.py (tensor2im :15-20,
save_image :177-179) and the torchvision.utils.save_image grid dumps in
train.ipynb cell 2 / test.ipynb cell 3.  Arrays here are host NHWC float
in [-1, 1], as the port's public functions return them (the eval step's
visuals, moved to the host with .cpu().numpy()).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image


def tensor2im(array) -> np.ndarray:
    """[-1,1] float [H,W,3] (or [1,H,W,3]) -> uint8 [H,W,3].

    Parity: util/util.py:15-20 ((x+1)/2*255, first batch element).
    """
    x = np.asarray(array, dtype=np.float32)
    if x.ndim == 4:
        x = x[0]
    x = (x + 1.0) / 2.0 * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def save_image(array, path: str) -> None:
    """Save one [-1,1] image array as a file (util/util.py:177-179)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(tensor2im(array)).save(path)


def make_grid(images: Sequence[np.ndarray], nrow: int = 2,
              padding: int = 2) -> np.ndarray:
    """Tile [-1,1] [H,W,3] images into one uint8 grid image.

    Role of torchvision.utils.save_image(..., nrow=2) in train.ipynb cell 2
    (the Epoch_(N) 2x2 visual dumps: real_A, real_B/ref, fake_P, fake_B).
    """
    tiles = [tensor2im(im) for im in images]
    h, w, _ = tiles[0].shape
    ncol = nrow  # torchvision's nrow = images per row
    nr = (len(tiles) + ncol - 1) // ncol
    grid = np.zeros((nr * h + (nr + 1) * padding,
                     ncol * w + (ncol + 1) * padding, 3), np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + c * (w + padding)
        grid[y:y + h, x:x + w] = t
    return grid


def save_grid(images: Sequence[np.ndarray], path: str, nrow: int = 2) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(make_grid(images, nrow)).save(path)


def load_image(path: str, size: int) -> np.ndarray:
    """PIL load -> RGB -> bilinear resize -> [-1,1] float32 [H,W,3].

    Parity with the reference's transform stack (train.ipynb cell 1):
    Resize((fineSize,fineSize)) + ToTensor + Normalize(0.5,0.5).
    """
    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def load_mask(path: str, size: int) -> np.ndarray:
    """PIL load -> resize -> float32 [H,W] in {0,1}, 1 = hole.

    Parity: transform_mask (Resize + ToTensor, train.ipynb cell 1) followed
    by the training loop's `mask[0][0] ... .bool()` channel-0 extraction
    (train.ipynb cell 2) — `.bool()` makes any nonzero pixel fully hole.
    """
    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    return (np.asarray(img, np.float32)[..., 0] > 0).astype(np.float32)
