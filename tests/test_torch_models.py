"""Port vs JAX: the three networks' forwards with bridged weights at the
tiny config, outputs and the InnerCos taps to 1e-4.

Both run the same f32 convolutions and norms in another summation order;
the attention level's hole here chains a few masked positions only, so
differences stay at a few ulps of O(1) activations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.models.vgg16 import apply_vgg16

from torch_port_helpers import (configs, flat_dicts, jax_params, nchw,
                                torch_models)

TOL = dict(rtol=1e-4, atol=1e-4)


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    jcfg, tcfg = configs()
    params = jax_params(jcfg, seed=2)
    tm = torch_models(tcfg, flat_dicts(params, tmp_path_factory.mktemp("w")))
    return jcfg, params, tm


def test_vgg_matches(nets):
    jcfg, params, tm = nets
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)
                                         ).astype(np.float32)
    want = apply_vgg16(params["vgg"], jnp.asarray(x), jcfg.vgg_width_scale)
    with torch.no_grad():
        got = tm.vgg(nchw(x))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), err_msg=name,
                                   **TOL)


def test_netP_matches(nets):
    jcfg, params, tm = nets
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)
                                         ).astype(np.float32)
    want = JI.build_models(jcfg).P.apply({"params": params["P"]},
                                         jnp.asarray(x))
    with torch.no_grad():
        got = tm.P(nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "lax"])
def test_netG_matches(nets, impl):
    """netG's output and both taps; the JAX side through either attention
    path, the port through its default (the plain scan on the CPU)."""
    jcfg, params, tm = nets
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 6)).astype(np.float32)
    ref = np.abs(rng.standard_normal((2, 8, 8, 64))).astype(np.float32)
    flag = np.zeros((2, 64), np.float32)
    flag[0, 27:30] = flag[0, 35:38] = 1
    flag[1, ::9] = 1
    G = JI.build_models(jcfg.replace(attention_impl=impl)).G
    want, want_taps = G.apply({"params": params["G"]}, jnp.asarray(x),
                              jnp.asarray(ref), jnp.asarray(flag))
    with torch.no_grad():
        got, taps = tm.G(nchw(x), nchw(ref), torch.from_numpy(flag))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    assert set(taps) == set(want_taps) == {"inner_cos", "inner_cos2"}
    for k in taps:
        np.testing.assert_allclose(_nhwc(taps[k]), np.asarray(want_taps[k]),
                                   err_msg=k, **TOL)


@pytest.mark.slow
def test_default_width_256px_matches(tmp_path):
    """One image through all three networks at the default widths."""
    jcfg, tcfg = configs(fine_size=256, ngf=64, vgg_width_scale=1.0)
    params = jax_params(jcfg, seed=4)
    tm = torch_models(tcfg, flat_dicts(params, tmp_path))
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    mask = np.zeros((1, 256, 256), np.uint8)
    mask[:, 100:124, 60:84] = 1
    from deepinpainting_torch.engine import inpaint as TI
    want_B, want_P = JI.make_inference_fn(jcfg)(
        params["G"], params["P"], params["vgg"], gt, mask, ref)
    got_B, got_P = TI.make_inference_fn(tcfg, "cpu")(*tm, gt, mask, ref)
    np.testing.assert_allclose(got_P.numpy(), np.asarray(want_P), **TOL)
    np.testing.assert_allclose(got_B.numpy(), np.asarray(want_B), **TOL)
