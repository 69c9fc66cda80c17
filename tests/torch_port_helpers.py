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
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.engine.checkpoint import export_network_npz
from deepinpainting_tpu.models.vgg16 import Vgg16 as JVgg16

from deepinpainting_torch.config import Config as TConfig
from deepinpainting_torch.convert.jax_bridge import (bridge_tensors,
                                                     load_flat)
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import attention as TA

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
    c3 = max(1, int(256 * cfg.vgg_width_scale))
    key = jax.random.PRNGKey(0)

    def keep(variables):
        # norm='batch': the whole variables dict ({'params', 'batch_stats'}),
        # as the JAX package's init_params keeps it; else the bare params
        variables = dict(variables)
        return variables if "batch_stats" in variables else variables["params"]

    return {
        "G": keep(jax.eval_shape(lambda: m.G.init(
            key, jnp.zeros((1, s, s, cfg.input_nc_g)),
            jnp.zeros((1, fs, fs, c4)), jnp.zeros((1, fs * fs))))),
        "P": keep(jax.eval_shape(lambda: m.P.init(
            key, jnp.zeros((1, s, s, cfg.input_nc))))),
        "vgg": jax.eval_shape(lambda: JVgg16(cfg.vgg_width_scale).init(
            key, jnp.zeros((1, 64, 64, 3))))["params"],
        "D": keep(jax.eval_shape(lambda: m.D.init(
            key, jnp.zeros((1, s, s, cfg.input_nc))))),
        "F": jax.eval_shape(lambda: m.F.init(
            key, jnp.zeros((1, fs, fs, c3))))["params"],
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
    if name == "var":                         # a running variance
        return (0.5 + rng.random(shape)).astype(np.float32)
    return (0.05 * rng.standard_normal(shape)).astype(np.float32)  # bias/offset


def jax_params(cfg: JConfig, seed: int = 0):
    """{'G', 'P', 'vgg', 'D', 'F'} JAX parameter trees filled from a numpy
    seed (in that order, so D and F leave the first three as they were)."""
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


def torch_discriminators(cfg: TConfig, flats) -> TI.Discriminators:
    """The port's netD and netF (CPU, train mode) with the bridged weights."""
    nets = TI.build_discriminators(cfg)
    for name, net in zip(("D", "F"), nets):
        load_flat(net, flats[name])
    return TI.Discriminators(*(net.train() for net in nets))


def torch_state(cfg: TConfig, flats) -> TI.TrainState:
    """A fresh TrainState on the CPU around the bridged weights."""
    G, P, vgg = torch_models(cfg, flats)
    D, F = torch_discriminators(cfg, flats)
    return TI.create_train_state(cfg, G.train(), P.train(), D, F, vgg)


def flat_of(tree):
    """A JAX pytree (parameters or gradients) as the flat dict of numpy
    arrays that export_network_npz would write."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def special_flags(case, b, n):
    """[b, n] f32 flags for the cases that the masked-rows-only schedules of
    the CUDA kernels make special (no row, every row, the first or the last
    row masked, a different hole per sample, an N that is no multiple of
    32)."""
    f = np.zeros((b, n), np.float32)
    if case == "every row":
        f[:] = 1
    elif case == "first row":
        f[:, 0] = 1
        f[:, n // 2:n // 2 + 4] = 1
    elif case == "last row":
        f[:, n - 1] = 1
        f[:, n // 3:n // 3 + 3] = 1
    elif case == "hole per sample":      # sample 0 has no masked row
        for i in range(b):
            f[i, 5 * i:5 * i + 4 * i] = 1
    else:
        assert case in ("no row", "ragged N")
        if case == "ragged N":
            f[:, 3::5] = 1
    return f


def tiny_batch(seed, b=2, size=64):
    """A uint8 training batch of `b` 64 px samples with small holes, of two
    kinds in turn: 7 and 5 masked positions on the 8x8 attention grid."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, size, size), np.uint8)
    mask[0::2, 10:30, 34:50] = 1
    mask[1::2, 40:52, 8:30] = 1
    mask[1::2, 6:14, 6:14] = 1      # too small to mask a feature position
    return {"image": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "ref": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "mask": mask}


TRAINED = ("G", "P", "D", "F")


def state_tensors(state, net):
    return {k: v.detach().clone()
            for k, v in getattr(state, net).state_dict().items()}


def state_grads(state, net):
    return {k: p.grad.detach().clone()
            for k, p in getattr(state, net).named_parameters()}


def near_integer_entries(kbar, flag):
    """How many kbar entries outside the rows that are one-hot by
    construction (unmasked rows, each sample's first masked row) lie within
    1e-4 of a non-zero integer.  `trunc` in the faithful backward is
    discontinuous there: 0.99999994 against 1.0 is 0 against 1."""
    kbar, flag = np.asarray(kbar), np.asarray(flag) > 0
    blended = flag.copy()
    for i, row in enumerate(flag):
        if row.any():
            blended[i, np.flatnonzero(row)[0]] = False
    values = kbar[blended]
    nearest = np.rint(values)
    return int(((np.abs(values - nearest) < 1e-4) & (nearest != 0)).sum())


def run_both(fields, params, flats, seeds=(1, 2)):
    """Two train steps in both packages from the same weights, fresh Adam
    state and the same two batches.  The JAX step runs jitted, as its own
    tests run it.  Returns the metrics of both steps on both sides, the
    port's parameters before and after the first step and its gradients,
    and the JAX first-step gradients and state entries in the port's layout.

    The JAX gradients are read back from Adam's first moment after the
    first step, g = mu / (1 - beta1): exact for beta1 = 0.5.  `risky` counts
    the first step's kbar entries on which `trunc` could go either way, and
    `kbar_max` is its largest entry (well above 1 after a near-cancelling
    at + vmax, where the recurrence amplifies every rounding difference),
    both over every kbar the first step built: one a differentiated
    forward and one more a recompute of a checkpointed level that encloses
    the attention level, a microbatch with grad_accum (its G phase).
    """
    jcfg, tcfg = configs(**fields)
    b1, b2 = (tiny_batch(seed, tcfg.batch_size) for seed in seeds)
    jstep = jax.jit(JI.make_train_step(jcfg))
    j0 = JST.create_train_state(jcfg, params)
    key = jax.random.PRNGKey(0)
    j1, jm1 = jstep(j0, {k: jnp.asarray(v) for k, v in b1.items()}, key)
    j2, jm2 = jstep(j1, {k: jnp.asarray(v) for k, v in b2.items()}, key)

    tstate = torch_state(tcfg, flats)
    tstep = TI.make_train_step(tcfg, "cpu")
    before = {n: state_tensors(tstate, n) for n in TRAINED + ("vgg",)}
    seen, core = [], TA.attention_core_batched

    def spy(feat, ref, flag, **kw):
        out, kbar = core(feat, ref, flag, **kw)
        seen.append((near_integer_entries(kbar, flag),
                     float(kbar.abs().max())))
        return out, kbar

    TA.attention_core_batched = spy
    try:
        same, tm1 = tstep(tstate, b1)
    finally:
        TA.attention_core_batched = core
    # remat: each checkpointed level of netG's levels 0-3 (those that
    # enclose the attention level) recomputes it once more
    enclosing = (0 if not tcfg.remat else 4 if tcfg.remat_depth == 0
                 else min(tcfg.remat_depth, 4))
    builds = max(1, tcfg.grad_accum) * (1 + enclosing)
    assert same is tstate and tstate.step == 1 and len(seen) == builds
    after = {n: state_tensors(tstate, n) for n in TRAINED + ("vgg",)}
    tgrads = {n: state_grads(tstate, n) for n in TRAINED}
    _, tm2 = tstep(tstate, b2)
    final = {n: state_tensors(tstate, n) for n in TRAINED}

    out = dict(jm1=jm1, jm2=jm2, tm1=tm1, tm2=tm2, before=before,
               after=after, final=final, tgrads=tgrads, tstate=tstate,
               j2=j2, tcfg=tcfg, risky=sum(r for r, _ in seen),
               kbar_max=max(m for _, m in seen),
               jgrads={}, jafter={}, jfinal={})
    for n in TRAINED:
        module = getattr(tstate, n)
        mu = getattr(j1, f"opt_{n}").inner_state[0].mu
        g = jax.tree_util.tree_map(lambda m: m / (1.0 - jcfg.beta1), mu)
        out["jgrads"][n] = bridge_tensors(flat_of(g), module)
        out["jafter"][n] = bridge_tensors(
            flat_of(getattr(j1, f"params_{n}")), module)
        out["jfinal"][n] = bridge_tensors(
            flat_of(getattr(j2, f"params_{n}")), module)
    return out
