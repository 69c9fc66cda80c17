"""Port vs JAX: the weight bridge and single layers.

Every G, P and VGG leaf that the JAX package's export_network_npz writes
must land on exactly one parameter of the port's networks.  Single layers
with bridged weights must match the JAX layers to 1e-5: both run the same
f32 sums, in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from deepinpainting_tpu.ops import convs as JC
from deepinpainting_torch.convert.jax_bridge import bridge_state_dict
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import convs as TC

from torch_port_helpers import configs, flat_dicts, jax_params, nchw, nhwc

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    jcfg, tcfg = configs()
    flats = flat_dicts(jax_params(jcfg, seed=1), tmp_path_factory.mktemp("w"))
    return tcfg, flats


@pytest.mark.parametrize("net", ["G", "P", "vgg"])
def test_every_leaf_bridged(bridged, net):
    tcfg, flats = bridged
    module = getattr(TI.build_models(tcfg), net)
    sd = bridge_state_dict(flats[net], module)
    assert len(sd) == len(flats[net]) == len(module.state_dict())
    module.load_state_dict(sd, strict=True)


def test_bridge_rejects_strays_and_gaps(bridged):
    tcfg, flats = bridged
    module = TI.build_models(tcfg).P
    flat = dict(flats["P"])
    with pytest.raises(KeyError):
        bridge_state_dict({**flat, "model/extra_conv/kernel": np.zeros(1)},
                          module)
    missing = dict(flat)
    missing.pop("model/up_conv/bias")
    with pytest.raises(KeyError):
        bridge_state_dict(missing, module)
    bad = dict(flat)
    bad["model/up_conv/bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError):
        bridge_state_dict(bad, module)


def _bridge_one(layer, kernel, bias):
    flat = {"kernel": np.asarray(kernel), "bias": np.asarray(bias)}
    holder = nn.Module()
    holder.layer = layer
    holder.load_state_dict(bridge_state_dict(
        {f"layer/{k}": v for k, v in flat.items()}, holder))
    return layer


@pytest.mark.parametrize("k,s,p,d,cin,cout,h", [
    (4, 2, 1, 1, 3, 8, 16),     # netP down
    (4, 2, 3, 2, 8, 8, 16),     # netG dilated down, keeps channels
    (3, 1, 1, 1, 8, 16, 8),     # same-size
    (4, 2, 3, 2, 8, 8, 1),      # innermost dilated conv on a 1x1 map
])
def test_conv2d_matches(k, s, p, d, cin, cout, h):
    rng = np.random.default_rng(k * 100 + p)
    x = rng.standard_normal((2, h, h, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    want = JC.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s, p, d)
    layer = _bridge_one(nn.Conv2d(cin, cout, k, s, p, dilation=d), w, b)
    with torch.no_grad():
        got = layer(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,s,p,cin,cout,h", [
    (4, 2, 1, 16, 8, 4),        # doubling upsample
    (3, 1, 1, 16, 8, 8),        # same-size, halves a skip concat
    (4, 2, 1, 8, 8, 1),         # innermost 1x1 -> 2x2
])
def test_conv_transpose2d_matches(k, s, p, cin, cout, h):
    rng = np.random.default_rng(k * 10 + h)
    x = rng.standard_normal((2, h, h, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    want = JC.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), s, p)
    layer = _bridge_one(nn.ConvTranspose2d(cin, cout, k, s, p), w, b)
    with torch.no_grad():
        got = layer(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_instance_norm_matches():
    rng = np.random.default_rng(7)
    x = (3.0 + 2.0 * rng.standard_normal((2, 8, 8, 5))).astype(np.float32)
    scale = rng.standard_normal((5,)).astype(np.float32)
    offset = rng.standard_normal((5,)).astype(np.float32)
    want = JC.instance_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(offset))
    norm = TC.InstanceNorm(5)
    holder = nn.Module()
    holder.norm = norm
    holder.load_state_dict(bridge_state_dict(
        {"norm/scale": scale, "norm/offset": offset}, holder))
    with torch.no_grad():
        got = norm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("src,dst", [(2, 1), (4, 8), (3, 6), (8, 4), (6, 3)])
def test_bilinear_resize_matches(src, dst):
    x = np.random.default_rng(src).standard_normal(
        (2, src, src, 3)).astype(np.float32)
    want = JC.bilinear_resize(jnp.asarray(x), dst, dst)
    got = TC.bilinear_resize(nchw(x), dst, dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_leaky_relu_matches():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_array_equal(
        TC.leaky_relu(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(JC.leaky_relu(jnp.asarray(x), 0.2)))


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
@pytest.mark.parametrize("transposed", [False, True])
def test_init_distributions_match(init_type, transposed):
    """Same distribution as make_init (not the same bits): the spread of
    the port's draw within 5% of the JAX draw's, for both layouts."""
    kh, cin, cout = 4, 32, 48
    jw = np.asarray(JC.make_init(init_type, 0.02, transposed)(
        jax.random.PRNGKey(0), (kh, kh, cin, cout)))
    shape = (cin, cout, kh, kh) if transposed else (cout, cin, kh, kh)
    tw = TC.init_weight_(torch.empty(shape), init_type, 0.02,
                         torch.Generator().manual_seed(0))
    assert abs(tw.std().item() / jw.std() - 1.0) < 0.05
    assert abs(tw.mean().item()) < 0.1 * jw.std()
    if init_type == "orthogonal":
        m = tw.reshape(shape[0], -1)
        gram = (m @ m.T).numpy() if m.shape[0] <= m.shape[1] else \
            (m.T @ m).numpy()
        np.testing.assert_allclose(gram, 0.02 ** 2 * np.eye(len(gram)),
                                   atol=1e-7)


def test_unknown_init_raises():
    with pytest.raises(NotImplementedError):
        TC.init_weight_(torch.empty(2, 2, 3, 3), "uniform", 0.02,
                        torch.Generator())
