"""Port vs JAX: the discriminators netD (image PatchGAN) and netF
(VGG-feature PatchGAN) with bridged weights.

Forwards must match to 1e-5 (relative and absolute): a few stacked f32
convolutions and norms, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_torch.config import Config as TConfig
from deepinpainting_torch.convert.jax_bridge import bridge_state_dict
from deepinpainting_torch.engine import inpaint as TI

from torch_port_helpers import (configs, flat_dicts, jax_params, nchw, nhwc,
                                torch_discriminators)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, _ = configs()
    params = jax_params(jcfg, seed=5)
    return params, flat_dicts(params, tmp_path_factory.mktemp("w"))


@pytest.mark.parametrize("net", ["D", "F"])
def test_every_leaf_bridged(weights, net):
    _, flats = weights
    _, tcfg = configs()
    module = getattr(TI.build_discriminators(tcfg), net)
    sd = bridge_state_dict(flats[net], module)
    assert len(sd) == len(flats[net]) == len(module.state_dict())
    module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("gan_type", ["lsgan", "vanilla"])
def test_netD_matches(weights, gan_type):
    params, flats = weights
    jcfg, tcfg = configs(gan_type=gan_type)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)
                                         ).astype(np.float32)
    want = JI.build_models(jcfg).D.apply({"params": params["D"]},
                                         jnp.asarray(x), True)
    D = torch_discriminators(tcfg, flats).D
    assert D.use_sigmoid == (gan_type == "vanilla")
    with torch.no_grad():
        got = D(nchw(x))
    assert got.shape == (2, 1, 6, 6)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [8, 4, 16])
def test_netF_matches(weights, size):
    """size 8 is relu3_3 of a 64 px image; 4 takes the zero-pad path up to
    8x8; 16 emits a 2x2 map."""
    params, flats = weights
    jcfg, tcfg = configs()
    c3 = max(1, int(256 * tcfg.vgg_width_scale))
    x = np.abs(np.random.default_rng(size).standard_normal(
        (2, size, size, c3))).astype(np.float32)
    want = JI.build_models(jcfg).F.apply({"params": params["F"]},
                                         jnp.asarray(x))
    F = torch_discriminators(tcfg, flats).F
    with torch.no_grad():
        got = F(nchw(x))
    assert got.shape[2:] == (max(size, 8) // 8,) * 2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_netF_pads_at_the_bottom_and_right():
    _, tcfg = configs()
    F = TI.build_discriminators(tcfg).F
    x = torch.randn(1, F.conv0.in_channels, 4, 4,
                    generator=torch.Generator().manual_seed(0))
    padded = torch.zeros(1, F.conv0.in_channels, 8, 8)
    padded[:, :, :4, :4] = x
    with torch.no_grad():
        assert torch.equal(F(x), F(padded))


def test_default_widths_have_the_published_parameter_counts():
    nets = TI.build_discriminators(TConfig())
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert count(nets.D) == 2_766_529
    assert count(nets.F) == 10_487_296


def test_init_discriminators_draws_from_the_generator():
    _, tcfg = configs()
    a = TI.init_discriminators(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = TI.init_discriminators(tcfg, torch.Generator().manual_seed(0), "cpu")
    c = TI.init_discriminators(tcfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a.D.conv1.weight, b.D.conv1.weight)
    assert not torch.equal(a.D.conv1.weight, c.D.conv1.weight)
    w = a.F.conv1.weight
    assert abs(w.std().item() / tcfg.init_gain - 1.0) < 0.05
    assert a.D.head.bias.abs().max() == 0
    assert (a.D.norm1.weight == 1).all() and (a.D.norm1.bias == 0).all()
    assert a.D.training and a.F.training
