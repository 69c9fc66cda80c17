"""Port vs JAX: mask math and input preparation, bit for bit.

Masks are 0/1 and every window sum of them is a dyadic fraction, so the
two packages must agree exactly (assert_array_equal), not to a tolerance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.config import Config as JConfig
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.ops import masks as JM
from deepinpainting_torch.config import Config as TConfig
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import masks as TM

from torch_port_helpers import nchw, nhwc


def _random_masks(b, s, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((b, s, s), np.uint8)
    for i in range(b):
        for _ in range(3):
            y, x = rng.integers(0, s - s // 4, 2)
            h, w = rng.integers(2, s // 4, 2)
            m[i, y:y + h, x:x + w] = 1
    return m


@pytest.mark.parametrize("size,overlap", [(64, 4), (256, 4), (256, 0)])
def test_center_mask(size, overlap):
    np.testing.assert_array_equal(
        TM.center_mask(size, overlap).numpy(),
        np.asarray(JM.center_mask(size, overlap)))


@pytest.mark.parametrize("mask_type", ["center", "random"])
@pytest.mark.parametrize("size", [64, 256])
def test_prepare_masks(mask_type, size):
    """resolve_mask + feat_mask + patch_flags through both engines."""
    jcfg = JConfig(fine_size=size, mask_type=mask_type)
    tcfg = TConfig(fine_size=size, mask_type=mask_type)
    raw = _random_masks(3, size, seed=size)
    jm = JI.resolve_mask(jcfg, JI.normalize_mask(jnp.asarray(raw)))
    jf, jflag = JI.prepare_masks(jcfg, jm)
    tm = TI.resolve_mask(tcfg, TI.normalize_mask(torch.from_numpy(raw)))
    tf, tflag = TI.prepare_masks(tcfg, tm)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tflag.numpy(), np.asarray(jflag))
    assert 0 < tflag.sum() < tflag.numel()


@pytest.mark.parametrize("patch_size,stride,thred", [(1, 1, 1.0),
                                                      (3, 1, 2.0),
                                                      (2, 2, 1.0)])
def test_patch_flags(patch_size, stride, thred):
    fm = (np.random.default_rng(3).random((2, 16, 16)) > 0.6
          ).astype(np.float32)
    want = jax.vmap(lambda f: JM.patch_flags(f, patch_size, stride, thred))(
        jnp.asarray(fm))
    got = TM.patch_flags(torch.from_numpy(fm), patch_size, stride, thred)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_feat_mask_fractional_threshold():
    """A soft (non-binary) mask and a different threshold, single mask."""
    m = np.random.default_rng(4).random((64, 64)).astype(np.float32)
    m = np.round(m * 4) / 4       # quarter steps keep the sums dyadic
    for thr in (0.25, 5.0 / 16.0, 0.5):
        np.testing.assert_array_equal(
            TM.feat_mask(torch.from_numpy(m), 3, thr).numpy(),
            np.asarray(JM.feat_mask(jnp.asarray(m), 3, thr)))


def test_hole_fill_and_zero():
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    mask = (rng.random((2, 16, 16)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(TM.fill_hole_with_mean(nchw(img), torch.from_numpy(mask))),
        np.asarray(JM.fill_hole_with_mean(jnp.asarray(img),
                                          jnp.asarray(mask))))
    np.testing.assert_array_equal(
        nhwc(TM.zero_hole(nchw(img), torch.from_numpy(mask))),
        np.asarray(JM.zero_hole(jnp.asarray(img), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        TM.expand_mask(torch.from_numpy(mask), 3).numpy().transpose(0, 2, 3, 1),
        np.asarray(JM.expand_mask(jnp.asarray(mask), 3)))
    assert TM.HOLE_FILL_RGB == JM.HOLE_FILL_RGB


def test_normalize_image_and_mask():
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        TI.normalize_image(torch.from_numpy(u8)).numpy(),
        np.asarray(JI.normalize_image(jnp.asarray(u8))))
    f = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TI.normalize_image(torch.from_numpy(f)).numpy(), f)
    m8 = rng.integers(0, 3, (2, 8, 8), dtype=np.uint8)
    np.testing.assert_array_equal(
        TI.normalize_mask(torch.from_numpy(m8)).numpy(),
        np.asarray(JI.normalize_mask(jnp.asarray(m8))))
    mf = (m8 > 0).astype(np.float32)
    np.testing.assert_array_equal(
        TI.normalize_mask(torch.from_numpy(mf)).numpy(), mf)


def test_config_json_loads_in_both_packages():
    j = JConfig(fine_size=128, ngf=16, attention_impl="lax")
    t = TConfig.from_json(j.to_json())
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert JConfig.from_json(TConfig().to_json()) == JConfig()
