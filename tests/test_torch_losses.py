"""Port vs JAX: the loss functions.

The same numpy inputs go through deepinpainting_tpu/losses.py and
deepinpainting_torch/losses.py.  Tolerance 1e-6 (relative and absolute):
each loss is a mean of a few thousand f32 terms, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu import losses as JL
from deepinpainting_torch import losses as TL

from torch_port_helpers import nchw

TOL = dict(rtol=1e-6, atol=1e-6)


def _preds(seed, gan_type):
    rng = np.random.default_rng(seed)
    fake = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    real = (0.3 + rng.standard_normal((2, 6, 6, 1))).astype(np.float32)
    if gan_type == "vanilla":      # netD ends in a sigmoid there
        fake, real = 1 / (1 + np.exp(-fake)), 1 / (1 + np.exp(-real))
    return fake.astype(np.float32), real.astype(np.float32)


@pytest.mark.parametrize("target_is_real", [True, False])
@pytest.mark.parametrize("gan_type", ["lsgan", "wgan_gp", "vanilla"])
def test_ra_gan_loss_matches(gan_type, target_is_real):
    fake, real = _preds(3, gan_type)
    want = JL.ra_gan_loss(jnp.asarray(fake), jnp.asarray(real),
                          target_is_real, gan_type)
    got = TL.ra_gan_loss(nchw(fake), nchw(real), target_is_real, gan_type)
    assert got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ra_gan_loss_directions_differ_and_unknown_type_raises():
    fake, real = (nchw(a) for a in _preds(4, "lsgan"))
    assert TL.ra_gan_loss(fake, real, True) != TL.ra_gan_loss(fake, real,
                                                              False)
    # lsgan and wgan_gp are the same MSE
    assert TL.ra_gan_loss(fake, real, True, "lsgan") == TL.ra_gan_loss(
        fake, real, True, "wgan_gp")
    with pytest.raises(ValueError):
        TL.ra_gan_loss(fake, real, True, "hinge")
    with pytest.raises(ValueError):
        JL.ra_gan_loss(jnp.zeros(2), jnp.zeros(2), True, "hinge")


def test_vanilla_clips_where_bce_is_undefined():
    """A relativistic difference at or below 0 (or at 1) is clipped into
    [1e-7, 1 - 1e-7]: the loss stays finite, and matches JAX there too."""
    fake = np.full((1, 2, 2, 1), 0.9, np.float32)
    real = np.full((1, 2, 2, 1), 0.1, np.float32)   # real - mean(fake) < 0
    for direction in (True, False):
        want = JL.ra_gan_loss(jnp.asarray(fake), jnp.asarray(real),
                              direction, "vanilla")
        got = TL.ra_gan_loss(nchw(fake), nchw(real), direction, "vanilla")
        assert torch.isfinite(got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_l1_loss_matches():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    b = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = JL.l1_loss(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(TL.l1_loss(nchw(a), nchw(b)).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_inner_cos_loss_matches(strength):
    """NHWC on the JAX side, NCHW on the port's: feat_mask [B,h,w]
    broadcasts over channels on both."""
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    target = np.abs(rng.standard_normal((2, 8, 8, 16))).astype(np.float32)
    fmask = (rng.random((2, 8, 8)) > 0.6).astype(np.float32)
    want = JL.inner_cos_loss(jnp.asarray(feat), jnp.asarray(fmask),
                             jnp.asarray(target), strength)
    got = TL.inner_cos_loss(nchw(feat), torch.from_numpy(fmask),
                            nchw(target), strength)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_losses_are_differentiable():
    fake = torch.randn(2, 1, 4, 4, generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    real = torch.randn(2, 1, 4, 4, generator=torch.Generator().manual_seed(1))
    for gan_type in ("lsgan", "vanilla"):
        pf = torch.sigmoid(fake) if gan_type == "vanilla" else fake
        pr = torch.sigmoid(real) if gan_type == "vanilla" else real
        g, = torch.autograd.grad(TL.ra_gan_loss(pf, pr, False, gan_type),
                                 fake)
        assert torch.isfinite(g).all() and g.abs().sum() > 0
