"""Evaluation metrics (PSNR/SSIM) and the structured metrics logger
(counterpart of deepinpainting_tpu/utils/metrics.py).

  * PSNR = 10*log10(2^2 / MSE) on [-1,1] images (peak-to-peak 2), 100 where
    the MSE is 0 (test.ipynb cell 3's formula).
  * SSIM as IQA_pytorch's `SSIM(channels=3)(real, fake, as_loss=False)`
    computes it on the [-1,1] tensors the reference feeds it: inputs times
    255 with C = (K*255)^2, an 11x11 Gaussian window of sigma 1.5, a
    valid-mode depthwise filter, K1 0.01, K2 0.03, and relu on the
    contrast-structure map, which clamps anticorrelated patches to 0.

Both take NCHW images and return one value per image, [B], as the
reference's evaluation scores each image (the JAX package computes the same
number per image with a vmap over batches of one).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def psnr(real: torch.Tensor, fake: torch.Tensor, peak: float = 2.0
         ) -> torch.Tensor:
    """Per-image PSNR [B] of [-1,1] images [B,...]."""
    mse = torch.mean(torch.square(real - fake).flatten(1), dim=1)
    return torch.where(mse == 0, torch.full_like(mse, 100.0),
                       10.0 * torch.log10(peak ** 2 / mse))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    r = (torch.arange(size, dtype=torch.float32, device=device)
         - (size - 1) / 2.0)
    g = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(real: torch.Tensor, fake: torch.Tensor, *, k1: float = 0.01,
         k2: float = 0.03, win_size: int = 11, sigma: float = 1.5
         ) -> torch.Tensor:
    """Per-image SSIM [B] of NCHW [-1,1] images, IQA_pytorch semantics."""
    x = real.to(torch.float32) * 255.0
    y = fake.to(torch.float32) * 255.0
    c = x.shape[1]
    c1, c2 = (k1 * 255.0) ** 2, (k2 * 255.0) ** 2
    win = _gaussian_window(win_size, sigma, x.device).expand(c, 1, -1, -1)

    def filt(t):
        return F.conv2d(t, win, groups=c)

    mu_x, mu_y = filt(x), filt(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = filt(x * x) - mu_xx
    sig_y = filt(y * y) - mu_yy
    sig_xy = filt(x * y) - mu_xy
    cs_map = F.relu((2 * sig_xy + c2) / (sig_x + sig_y + c2))
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3))


class MetricsLogger:
    """Per-step scalar metrics -> CSV, epoch summaries, loss-curve PNG."""

    def __init__(self, out_dir: str, filename: str = "metrics.csv"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.path = os.path.join(out_dir, filename)
        self._fields: Optional[List[str]] = None
        self._file = None
        self._writer = None
        self.epoch_train: List[float] = []
        self.epoch_valid: List[float] = []

    def log_step(self, step: int, metrics: Dict[str, float],
                 when: Optional[float] = None) -> None:
        """`when` lets a caller that buffers metrics (the trainer's
        windowed fetch) record the step's own wall time instead of the
        flush time."""
        row = {"step": step, "time": when if when is not None else
               time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None:
            self._fields = list(row)
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=self._fields)
            self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in self._fields})
        self._file.flush()

    def log_epoch(self, epoch: int, train_loss: float,
                  valid_loss: float) -> None:
        """The reference's epoch print (train.ipynb cell 2)."""
        self.epoch_train.append(train_loss)
        self.epoch_valid.append(valid_loss)
        print("Epoch : %d -> Train loss : %f, Valid loss : %f"
              % (epoch, train_loss, valid_loss))

    def save_loss_plot(self, path: Optional[str] = None) -> Optional[str]:
        """Loss-curve PNG with the early-stop checkpoint marker
        (train.ipynb cell 2 tail): training loss blue, validation loss
        orange, a dashed red line at the best validation epoch.  Drawn
        with PIL, which the data pipeline needs anyway, so the figure
        needs no plotting library."""
        if not self.epoch_valid:
            return None
        from PIL import Image, ImageDraw
        path = path or os.path.join(self.out_dir, "loss_plot.png")
        w, h, m = 800, 640, 60
        img = Image.new("RGB", (w, h), "white")
        draw = ImageDraw.Draw(img)
        series = [(self.epoch_train, (31, 119, 180), "Training Loss"),
                  (self.epoch_valid, (255, 127, 14), "Validation Loss")]
        values = [v for ys, _, _ in series for v in ys if np.isfinite(v)]
        lo, hi = (min(values), max(values)) if values else (0.0, 1.0)
        hi = hi if hi > lo else lo + 1.0
        n = max(len(self.epoch_train), 2)

        def xy(i, v):
            return (m + (w - 2 * m) * i / (n - 1),
                    h - m - (h - 2 * m) * (v - lo) / (hi - lo))

        draw.rectangle([m, m, w - m, h - m], outline="black")
        for ys, color, label in series:
            pts = [xy(i, v) for i, v in enumerate(ys) if np.isfinite(v)]
            if len(pts) > 1:
                draw.line(pts, fill=color, width=2)
            for x, y in pts:
                draw.ellipse([x - 3, y - 3, x + 3, y + 3], fill=color)
        if any(np.isfinite(self.epoch_valid)):
            x = xy(int(np.nanargmin(self.epoch_valid)), lo)[0]
            for y in range(m, h - m, 12):
                draw.line([(x, y), (x, min(y + 6, h - m))], fill="red")
        for k, (_, color, label) in enumerate(series):
            draw.text((m + 10, m + 10 + 16 * k), label, fill=color)
        draw.text((w // 2 - 20, h - m + 20), "epochs", fill="black")
        draw.text((10, m - 20), f"loss {lo:.4g} .. {hi:.4g}", fill="black")
        img.save(path)
        return path

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None
