"""The port's initial draw (engine/inpaint.py::init_params / create_state)
held to the JAX package's, leaf by leaf, for the full Config() at four
seeds (tests/test_torch_init_tiny.py holds the tiny test configuration
under each init type and norm).

The two packages draw from different generators (torch's and
jax.random), so the values differ; the distributions must not.  For every
leaf of G, P, D, F and VGG, keyed as the JAX package's export_network_npz
keys it (the port's through convert/jax_bridge.py::flat_dict):
  * the same set of leaves and the same shapes;
  * conv and transposed-conv kernels: mean and standard deviation of the
    port's draw against JAX's within sampling error (5 standard errors of
    the difference), and each against the distribution init_type sets,
    with the fans of torch's convention (a transposed conv's fan_in is
    its output channels x kh x kw); VGG's he_normal truncated at 2 sigma
    of its underlying normal, in both;
  * biases, norm offsets and running means exactly 0; InstanceNorm scales
    and running variances exactly 1; BatchNorm scales from N(1, gain);
  * create_state: step 0, Adam's hyperparameters and empty moments
    (tests/test_torch_init_tiny.py).
"""

import math

import numpy as np
import pytest
import torch

import jax

from deepinpainting_tpu.config import Config as JConfig
from deepinpainting_tpu.engine import inpaint as JI

from deepinpainting_torch.config import Config as TConfig
from deepinpainting_torch.convert.jax_bridge import flat_dict
from deepinpainting_torch.engine import inpaint as TI

from torch_port_helpers import TINY

SEEDS = (0, 1, 2, 3)
Z = 5.0                 # standard errors allowed
NETS = ("G", "P", "D", "F", "vgg")
TRUNC_STD = 0.87962566103423978   # std of N(0,1) truncated at +-2


def jax_flat(tree) -> dict:
    """export_network_npz's flat keys and arrays, in memory."""
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in keypath)
        out[name] = np.asarray(leaf)
    return out


def port_nets(cfg: TConfig, seed: int):
    state = TI.create_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    return state, {n: getattr(state, n) for n in NETS}


def kernel_sigma(module, key: str, cfg) -> tuple:
    """(sigma, truncated) of the distribution the kernel at flat key `key`
    of the port's `module` is drawn from."""
    if isinstance(module, TI.Vgg16):
        layer = getattr(module, key[:-len("_kernel")])
        fan_in = math.prod(layer.weight.shape[1:])
        return math.sqrt(2.0 / fan_in), True
    path = [p for p in key.split("/")[:-1] if p != "params"]
    layer = module.get_submodule(".".join(path))
    w = layer.weight
    rf = math.prod(w.shape[2:])
    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    if cfg.init_type == "normal":
        return cfg.init_gain, False
    if cfg.init_type == "xavier":
        return cfg.init_gain * math.sqrt(2.0 / (fan_in + fan_out)), False
    if cfg.init_type == "kaiming":
        return math.sqrt(2.0 / fan_in), False
    raise ValueError(cfg.init_type)


def check_leaf(net: str, key: str, t: np.ndarray, j: np.ndarray, module,
               cfg) -> list:
    """What is wrong with the port's leaf `t` against JAX's `j`."""
    bad = []
    if t.shape != j.shape:
        return [f"{net}:{key} shape {t.shape} vs {j.shape}"]
    leaf = key.split("_")[-1] if net == "vgg" else key.split("/")[-1]
    n = t.size
    # f32 leaves, f64 sums
    mean = {"port": t.mean(dtype=np.float64), "jax": j.mean(dtype=np.float64)}
    std = {"port": t.std(dtype=np.float64), "jax": j.std(dtype=np.float64)}
    if leaf == "kernel":
        sigma, truncated = kernel_sigma(module, key, cfg)
        # the std of a sample's std, and of its mean; a normal truncated
        # at 2 sigma has a smaller fourth moment, so the normal's is an
        # upper bound
        se_std, se_mean = sigma / math.sqrt(2 * n), sigma / math.sqrt(n)
        for who, x in (("port", t), ("jax", j)):
            if abs(std[who] - sigma) > Z * se_std:
                bad.append(f"{net}:{key} {who} std {std[who]:.6g}, "
                           f"want {sigma:.6g}")
            if abs(mean[who]) > Z * se_mean:
                bad.append(f"{net}:{key} {who} mean {mean[who]:.3g}")
            if truncated and np.abs(x).max() > 2 * sigma / TRUNC_STD:
                bad.append(f"{net}:{key} {who} past the 2-sigma cut")
        if abs(std["port"] - std["jax"]) > Z * se_std * math.sqrt(2):
            bad.append(f"{net}:{key} std port {std['port']:.6g} vs jax "
                       f"{std['jax']:.6g}")
        if abs(mean["port"] - mean["jax"]) > Z * se_mean * math.sqrt(2):
            bad.append(f"{net}:{key} mean port {mean['port']:.3g} vs jax "
                       f"{mean['jax']:.3g}")
        return bad
    if leaf in ("bias", "offset", "mean"):
        want = 0.0
    elif leaf == "var" or (leaf == "scale" and cfg.norm == "instance"):
        want = 1.0
    elif leaf == "scale":         # BatchNorm: N(1, init_gain), both
        s = cfg.init_gain
        for who in ("port", "jax"):
            if (abs(mean[who] - 1.0) > Z * s / math.sqrt(n)
                    or abs(std[who] - s) > Z * s / math.sqrt(2 * n)):
                bad.append(f"{net}:{key} {who} mean {mean[who]:.6g} std "
                           f"{std[who]:.6g}, want N(1, {s})")
        return bad
    else:
        return [f"{net}:{key}: a leaf of unknown kind"]
    for who, x in (("port", t), ("jax", j)):
        if not np.all(x == want):
            bad.append(f"{net}:{key} {who} not all {want}")
    return bad


def compare_draws(jcfg: JConfig, tcfg: TConfig, seeds, init) -> dict:
    """{seed: problems} over every leaf of every network."""
    out = {}
    for seed in seeds:
        jtree = init(jax.random.PRNGKey(seed))
        _, tnets = port_nets(tcfg, seed)
        problems, counted = [], 0
        for net in NETS:
            jf = jax_flat(jtree[net])
            tf = flat_dict(tnets[net])
            if sorted(jf) != sorted(tf):
                problems.append(f"{net}: leaves only in JAX "
                                f"{sorted(set(jf) - set(tf))}, only in the "
                                f"port {sorted(set(tf) - set(jf))}")
                continue
            for key in jf:
                problems += check_leaf(net, key, tf[key], jf[key],
                                       tnets[net], tcfg)
                counted += 1
        out[seed] = (counted, problems)
        del jtree, tnets
    return out


def test_full_config_draw_matches_jax_leaf_by_leaf():
    """Config() as the protocols and chip_smoke.py build it: 256 px,
    ngf = ndf = 64, full-width VGG, normal(0, 0.02), instance norm."""
    # the draw is the same under either attention; "lax" compiles faster
    jcfg, tcfg = JConfig(attention_impl="lax"), TConfig(attention_impl="lax")
    # one compile of JAX's init for the four seeds
    init = jax.jit(lambda key: JI.init_params(jcfg, key))
    res = compare_draws(jcfg, tcfg, SEEDS, init)
    for seed, (counted, problems) in res.items():
        assert counted > 150, (seed, counted)
        assert not problems, (seed, problems)


def test_transposed_fans_are_torchs():
    """The fans the checks above use: a ConvTranspose2d weight [I, O, kh,
    kw] has fan_in O*kh*kw (torch's convention, which JAX's make_init
    follows with transposed=True), so kaiming's spread differs from the
    Conv2d of the same channels."""
    cfg = TConfig(**TINY, init_type="kaiming")
    _, nets = port_nets(cfg, 0)
    seen = 0
    for name, m in nets["G"].named_modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            i, o, kh, kw = m.weight.shape
            key = "/".join(name.split(".")) + "/kernel"
            assert kernel_sigma(nets["G"], key, cfg)[0] == pytest.approx(
                math.sqrt(2.0 / (o * kh * kw)))
            seen += 1
    assert seen >= 3
