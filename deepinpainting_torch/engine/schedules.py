"""Epoch-level learning-rate policies (the port's own copy of
deepinpainting_tpu/engine/schedules.py; pure Python).

'lambda' linear decay, 'step' (gamma 0.1 every lr_decay_iters), 'plateau'
(factor 0.2, patience 5, threshold 0.01, min mode), 'cosine' (T_max=niter,
eta_min=0).  All are indexed by epoch; the caller applies the value with
engine/state.py::set_learning_rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..config import Config


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """lr multiplier policies that are pure functions of the epoch."""
    if cfg.lr_policy == "lambda":
        # 1 - max(0, epoch + 1 + epoch_count - niter) / (niter_decay + 1)
        mult = 1.0 - max(0, epoch + 1 + cfg.epoch_count - cfg.niter) / float(
            cfg.niter_decay + 1)
        return cfg.lr * mult
    if cfg.lr_policy == "step":
        return cfg.lr * (0.1 ** (epoch // cfg.lr_decay_iters))
    if cfg.lr_policy == "cosine":
        return 0.5 * cfg.lr * (1 + math.cos(math.pi * epoch / cfg.niter))
    if cfg.lr_policy == "plateau":
        raise ValueError("plateau policy is stateful; use PlateauScheduler")
    raise NotImplementedError(f"lr policy {cfg.lr_policy!r}")


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01, patience=5).

    Matches torch's default threshold_mode='rel': an improvement means
    metric < best * (1 - threshold).
    """
    lr: float
    factor: float = 0.2
    patience: int = 5
    threshold: float = 0.01
    best: float = field(default=math.inf)
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


@dataclass
class EarlyStopping:
    """Patience counter on validation loss: every epoch that does not
    improve on the best score counts (strict '<'), and an improvement
    resets the counter."""
    patience: int = 20
    best_score: float = None  # type: ignore
    counter: int = 0
    early_stop: bool = False

    def __call__(self, val_loss: float) -> bool:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
        elif score < self.best_score:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.counter = 0
        return self.early_stop
