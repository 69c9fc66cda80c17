"""Host-side image augmentations (numpy/PIL), torchvision semantics (the
port's own copy of deepinpainting_tpu/data/transforms.py).

The reference's ref-image pipeline (train.ipynb cell 1, transform_ref) is
RandomResizedCrop(size, scale=(0.8,1.0), ratio=(1,1)) + ColorJitter(0.1,
0.1, 0.1, 0.1) + ToTensor + Normalize(0.5,0.5).  These reimplement the
torchvision sampling rules on PIL images and draw from the generator in
the JAX package's order, so both packages make the same batches bit for
bit.  numpy and PIL only: spawned loader workers import no torch.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from PIL import Image, ImageEnhance


def random_resized_crop(rng: np.random.Generator, img: Image.Image,
                        size: int, scale: Tuple[float, float] = (0.8, 1.0),
                        ratio: Tuple[float, float] = (1.0, 1.0)
                        ) -> Image.Image:
    """torchvision RandomResizedCrop.get_params sampling: 10 attempts at
    (area ~ U(scale)*A, log-aspect ~ U(log ratio)), then center fallback."""
    width, height = img.size
    area = float(width * height)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return img.resize((size, size), Image.BILINEAR,
                              box=(j, i, j + w, i + h))
    # fallback: center crop at the clamped aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return img.resize((size, size), Image.BILINEAR, box=(j, i, j + w, i + h))


def _adjust_hue(img: Image.Image, factor: float) -> Image.Image:
    """torchvision adjust_hue: shift the H channel of HSV by factor*255."""
    if abs(factor) < 1e-8:
        return img
    h, s, v = img.convert("HSV").split()
    h_np = np.asarray(h, np.int16)
    h_np = ((h_np + int(round(factor * 255.0))) % 256).astype(np.uint8)
    return Image.merge("HSV", (Image.fromarray(h_np, "L"), s, v)).convert(
        "RGB")


def color_jitter(rng: np.random.Generator, img: Image.Image,
                 brightness: float = 0.1, contrast: float = 0.1,
                 saturation: float = 0.1, hue: float = 0.1) -> Image.Image:
    """torchvision ColorJitter: each factor ~ U(max(0,1-x), 1+x) (hue
    ~ U(-h,h)), applied in a random permutation order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda im, f=f: _adjust_hue(im, f))
    for i in rng.permutation(len(ops)):
        img = ops[int(i)](img)
    return img


def to_normalized_array(img: Image.Image) -> np.ndarray:
    """ToTensor + Normalize(0.5,0.5): uint8 PIL -> float32 [H,W,3] in [-1,1]."""
    return np.asarray(img, np.float32) / 127.5 - 1.0


def to_uint8_array(img: Image.Image) -> np.ndarray:
    """Raw uint8 [H,W,3] — the cheap host->device transport form.  The
    normalization to [-1,1] (`x/127.5 - 1`, identical f32 arithmetic to
    `to_normalized_array`) runs on the device
    (engine/inpaint.py::normalize_image), cutting batch upload bytes 4x."""
    return np.asarray(img, np.uint8)
