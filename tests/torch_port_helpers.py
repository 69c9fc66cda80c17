"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*).

Weights are made from a numpy seed in the JAX package's parameter layout
(shapes from `jax.eval_shape` of each network's init, so no JAX init runs),
exported with the JAX package's own `export_network_npz`, and bridged into
the port with `convert/jax_bridge.py`.  Both packages then see the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deepinpainting_tpu.config import Config as JConfig
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine.checkpoint import export_network_npz
from deepinpainting_tpu.models.vgg16 import Vgg16 as JVgg16

from deepinpainting_torch.config import Config as TConfig
from deepinpainting_torch.convert.jax_bridge import load_flat
from deepinpainting_torch.engine import inpaint as TI

# The tiny test configuration.  64 px is the smallest size the port
# builds (see engine/inpaint.py::build_models).
TINY = dict(fine_size=64, ngf=8, ndf=8, vgg_width_scale=1 / 8)

torch.set_num_threads(2)


def configs(**kw):
    """(JAX Config, port Config) with the same fields."""
    fields = dict(TINY, **kw)
    return JConfig(**fields), TConfig(**fields)


def _templates(cfg: JConfig):
    m = JI.build_models(cfg)
    s, fs = cfg.fine_size, cfg.fine_size // 8
    c4 = max(1, int(512 * cfg.vgg_width_scale))
    key = jax.random.PRNGKey(0)
    return {
        "G": jax.eval_shape(lambda: m.G.init(
            key, jnp.zeros((1, s, s, cfg.input_nc_g)),
            jnp.zeros((1, fs, fs, c4)), jnp.zeros((1, fs * fs))))["params"],
        "P": jax.eval_shape(lambda: m.P.init(
            key, jnp.zeros((1, s, s, cfg.input_nc))))["params"],
        "vgg": jax.eval_shape(lambda: JVgg16(cfg.vgg_width_scale).init(
            key, jnp.zeros((1, 64, 64, 3))))["params"],
    }


def _fill(rng, path, sd):
    name = str(getattr(path[-1], "key", path[-1]))
    shape = sd.shape
    if name.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        std = np.sqrt(2.0 / fan_in)           # keeps activations O(1)
        return (std * rng.standard_normal(shape)).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (0.05 * rng.standard_normal(shape)).astype(np.float32)  # bias/offset


def jax_params(cfg: JConfig, seed: int = 0):
    """{'G', 'P', 'vgg'} JAX parameter trees filled from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {k: jax.tree_util.tree_map_with_path(
                lambda p, sd: jnp.asarray(_fill(rng, p, sd)), tree)
            for k, tree in _templates(cfg).items()}


def flat_dicts(params, tmpdir):
    """Each network exported with export_network_npz and read back."""
    out = {}
    for name, tree in params.items():
        path = str(tmpdir / f"{name}.npz")
        export_network_npz(tree, path)
        with np.load(path) as raw:
            out[name] = dict(raw)
    return out


def torch_models(cfg: TConfig, flats) -> TI.Models:
    """The port's networks (CPU, eval) with the bridged weights."""
    models = TI.build_models(cfg)
    for name, net in zip(("G", "P", "vgg"), models):
        load_flat(net, flats[name])
    return TI.Models(*(net.eval() for net in models))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)
