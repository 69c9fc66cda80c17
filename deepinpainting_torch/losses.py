"""Loss functions: relativistic-average GAN loss, L1, InnerCos feature MSE
(counterpart of deepinpainting_tpu/losses.py).

  * `ra_gan_loss(pred_fake, pred_real, target_is_real, gan_type)`: 'lsgan'
    and 'wgan_gp' select MSE, 'vanilla' BCE.  Discriminator direction
    (target_is_real=True):

        ( mean((real - mean(fake) - 1)^2)
        + mean((fake - mean(real) + 1)^2) ) / 2

    and the generator direction flips the signs.  Inside a process group
    (parallel/collectives.py::use_group) mean(fake) and mean(real) are the
    global batch's, as under the JAX package's SPMD step: one all-reduce of
    the two local sums, with autograd.  The outer means stay local, and the
    data-parallel step averages every rank's losses.
  * L1 terms: (L1(fake_B, gt) + L1(fake_P, gt)) * lambda_A, the sum taken
    by the train step.  On slabs (spatial partitioning) the mean is the
    whole image's, over every slab.
  * `inner_cos_loss`: MSE(feat * feat_mask * strength, vgg_gt_relu4_3), the
    target being the whole unmasked feature map.
"""

from __future__ import annotations

import torch

import torch.distributed as dist

from .parallel.collectives import (all_reduce_sum, current_group,
                                   spatial_mean)


def _mse(a: torch.Tensor, b: float) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _bce_with_labels(pred: torch.Tensor, label: float) -> torch.Tensor:
    """BCE on probabilities with the relativistic difference clipped into
    [1e-7, 1 - 1e-7] first: the difference lies in (-1, 1), where BCE is
    undefined, and the JAX package keeps 'vanilla' usable the same way."""
    p = torch.clamp(pred, 1e-7, 1 - 1e-7)
    return -torch.mean(label * torch.log(p) + (1 - label) * torch.log(1 - p))


def _batch_means(a: torch.Tensor, b: torch.Tensor):
    """(mean(a), mean(b)) over the batch, the global one inside a
    process group (a and b have the same shape on every rank)."""
    group = current_group()
    if group is None:
        return torch.mean(a), torch.mean(b)
    sums = all_reduce_sum(torch.stack([a.sum(), b.sum()]), group)
    return (sums / (a.numel() * dist.get_world_size(group))).unbind()


def ra_gan_loss(pred_fake: torch.Tensor, pred_real: torch.Tensor,
                target_is_real: bool, gan_type: str = "lsgan") -> torch.Tensor:
    """Relativistic-average GAN loss; argument order (pred_on_fake,
    pred_on_real, discriminator direction?)."""
    mean_fake, mean_real = _batch_means(pred_fake, pred_real)
    real_rel = pred_real - mean_fake
    fake_rel = pred_fake - mean_real
    if gan_type in ("lsgan", "wgan_gp"):
        if target_is_real:
            return 0.5 * (_mse(real_rel, 1.0) + _mse(fake_rel, -1.0))
        return 0.5 * (_mse(real_rel, -1.0) + _mse(fake_rel, 1.0))
    if gan_type == "vanilla":
        if target_is_real:
            return 0.5 * (_bce_with_labels(real_rel, 1.0)
                          + _bce_with_labels(fake_rel, 0.0))
        return 0.5 * (_bce_with_labels(real_rel, 0.0)
                      + _bce_with_labels(fake_rel, 1.0))
    raise ValueError(f"unknown gan_type {gan_type!r}")


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return spatial_mean(torch.abs(a - b))


def inner_cos_loss(feat: torch.Tensor, feat_mask: torch.Tensor,
                   target: torch.Tensor, strength: float = 1.0
                   ) -> torch.Tensor:
    """InnerCos feature-consistency MSE.  feat: [B, C, h, w] tap from the
    generator; feat_mask: [B, h, w] (1 = hole), broadcast over channels;
    target: [B, C, h, w] VGG relu4_3 of the ground truth."""
    masked = feat * feat_mask[:, None] * strength
    return torch.mean(torch.square(masked - target))
