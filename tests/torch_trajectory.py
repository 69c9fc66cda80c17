"""A training trajectory of the port held to the JAX package's: the same
weights (bridged), the same batch stream, K steps
of `make_train_step` in both packages, and JAX's own envelope around its
trajectory, the largest departure of JAX from itself when its starting
weights are nudged by one ulp (four nudges).

Used by tests/test_torch_trajectory*.py (tiny configuration, a few tens of
steps), studies/trajectory_scan.py and studies/jax_cpu_protocol.py
(`--run pair`: the protocol's width, more steps).
"""

from __future__ import annotations

import copy
import math

from typing import Callable, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST

from deepinpainting_torch.convert.jax_bridge import bridge_adam_state
from deepinpainting_torch.convert.jax_bridge import flat_dict
from deepinpainting_torch.data import synth
from deepinpainting_torch.engine import inpaint as TI

from torch_port_helpers import _templates, configs, flat_of, torch_state

LOSSES = ("D", "F", "G_GAN", "G_L1", "cosis")
TRAINED = ("G", "P", "D", "F")
# the losses, and each trained network's parameters
QUANTITIES = LOSSES + tuple(f"theta_{n}" for n in TRAINED)
NUDGES = 4
FACTOR = 8.0              # the port's limit: 8x JAX's own envelope
TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated at +-2

_JIT: Dict[tuple, Callable] = {}
_DRAWS: Dict[tuple, dict] = {}


def synth_batches(n: int, b: int = 2, size: int = 64, seed: int = 0
                  ) -> List[dict]:
    """`n` uint8 batches of `b` synthetic scenes and holes (data/synth.py,
    the protocols' generator), the reference being the image itself as
    the protocols' refroot = dataroot makes it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.stack([synth.make_image(rng, size) for _ in range(b)])
        mask = np.stack([synth.make_mask(rng, size) > 0 for _ in range(b)])
        out.append({"image": img, "ref": img.copy(),
                    "mask": mask.astype(np.uint8)})
    return out


def nudge(params, i: int):
    """Every leaf moved by one ulp, up or down at random (seed i)."""
    rng = np.random.default_rng(1000 + i)

    def one(x):
        x = np.asarray(x, np.float32)
        up = rng.random(x.shape) < 0.5
        return jnp.asarray(np.where(up, np.nextafter(x, np.float32(np.inf)),
                                    np.nextafter(x, np.float32(-np.inf))))
    return jax.tree_util.tree_map(one, params)


def _vectors(trees: dict) -> Dict[str, np.ndarray]:
    """{net: its parameters as one f64 vector, flat keys sorted}."""
    out = {}
    for net, flat in trees.items():
        out[net] = np.concatenate([np.asarray(flat[k], np.float64).ravel()
                                   for k in sorted(flat)])
    return out


def jax_run(fields: dict, params, batches) -> dict:
    """K steps of the JAX package's jitted train step: per-step losses
    and per-step parameter vectors of each trained network."""
    jcfg, _ = configs(**fields)
    key = tuple(sorted(fields.items()))
    if key not in _JIT:
        _JIT[key] = jax.jit(JI.make_train_step(jcfg))
    step = _JIT[key]
    state = JST.create_train_state(jcfg, params)
    rng = jax.random.PRNGKey(0)
    losses, thetas, grad = [], [], None
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        rng)
        losses.append({k: float(m[k]) for k in LOSSES})
        thetas.append(_vectors({n: flat_of(JST.params_of(
            getattr(state, f"params_{n}"))) for n in TRAINED}))
        if grad is None:    # Adam's first moment after one step: (1-b1) g
            grad = {k: np.asarray(v) / (1 - jcfg.beta1) for k, v in
                    flat_of(state.opt_G.inner_state[0].mu).items()}
    return {"losses": losses, "thetas": thetas, "grad_G": grad}


def port_run(fields: dict, params, batches,
             adam_count: int = 0, beta1: Optional[float] = None) -> dict:
    """The same K steps through the port's make_train_step from the same
    weights (bridged).  `adam_count` starts every Adam at that step count
    (zero moments) and `beta1` replaces the port's beta1: the controls."""
    _, tcfg = configs(**fields)
    if beta1 is not None:
        tcfg = tcfg.replace(beta1=beta1)
    flats = {n: flat_of(params[n]) for n in params}
    state = torch_state(tcfg, flats)
    if adam_count:
        for n in TRAINED:
            net = getattr(state, n)
            zeros = {k: np.zeros_like(v) for k, v in flat_dict(net).items()
                     if not k.startswith("batch_stats/")}
            bridge_adam_state(getattr(state, f"opt_{n}"), net, adam_count,
                              zeros, zeros)
    step = TI.make_train_step(tcfg, "cpu")
    losses, thetas, grad = [], [], None
    for b in batches:
        _, m = step(state, b)
        losses.append({k: float(m[k]) for k in LOSSES})
        thetas.append(_vectors({
            n: {k: v for k, v in flat_dict(getattr(state, n)).items()
                if not k.startswith("batch_stats/")} for n in TRAINED}))
        if grad is None:    # G's first gradient, keyed as JAX's
            moments = copy.deepcopy(state.G)
            with torch.no_grad():
                for p, q in zip(state.G.parameters(), moments.parameters()):
                    q.copy_(state.opt_G.state[p]["exp_avg"]
                            / (1 - tcfg.beta1))
            grad = {k.removeprefix("params/"): v
                    for k, v in flat_dict(moments).items()
                    if not k.startswith("batch_stats/")}
    return {"losses": losses, "thetas": thetas, "grad_G": grad}


def departures(run: dict, ref: dict) -> dict:
    """Per step: |loss - ref's| for each loss, and ||theta - ref's||_2 for
    each trained network; and under "grad_G" the largest entry of G's
    first gradient's departure."""
    out = {k: [] for k in QUANTITIES}
    for lo, lr, to, tr in zip(run["losses"], ref["losses"], run["thetas"],
                              ref["thetas"]):
        for k in LOSSES:
            out[k].append(abs(lo[k] - lr[k]))
        for n in TRAINED:
            out[f"theta_{n}"].append(float(np.linalg.norm(to[n] - tr[n])))
    out["grad_G"] = max(float(np.abs(run["grad_G"][k] - v).max())
                        for k, v in ref["grad_G"].items())
    return out


def draw(jcfg, seed: int, jax_init: bool = False) -> dict:
    """Starting weights: the protocols' distributions (init_type 'normal':
    N(0, init_gain) kernels, zero biases and offsets, unit scales; VGG's
    he_normal truncated at 2 sigma), drawn by numpy from `seed` into
    JAX's parameter trees (tests/test_torch_init.py holds both packages'
    own draws to these distributions); or, with `jax_init`, JAX's own
    init_params at `seed` (slower: it compiles the networks' init)."""
    key = (jcfg.fine_size, jcfg.ngf, jcfg.ndf, jcfg.vgg_width_scale,
           jcfg.norm, jcfg.init_gain, seed, jax_init)
    if key in _DRAWS:
        return _DRAWS[key]
    if jax_init:
        params = JI.init_params(jcfg, jax.random.PRNGKey(seed))
        params = {n: params[n] for n in TRAINED + ("vgg",)}
    else:
        if jcfg.init_type != "normal" or jcfg.norm != "instance":
            raise NotImplementedError("numpy draw: init 'normal', "
                                      "instance norm")
        rng = np.random.default_rng(seed)

        def leaf(net, path, sd):
            name = str(getattr(path[-1], "key", path[-1]))
            if name.endswith("kernel"):
                if net != "vgg":
                    return jcfg.init_gain * rng.standard_normal(sd.shape)
                std = math.sqrt(2.0 / math.prod(sd.shape[:-1]))
                x = rng.standard_normal(sd.shape)
                while np.any(np.abs(x) > 2):      # redraw past 2 sigma
                    out = np.abs(x) > 2
                    x[out] = rng.standard_normal(int(out.sum()))
                return std / TRUNC_STD * x
            return np.full(sd.shape, 1.0 if name == "scale" else 0.0)

        params = {n: jax.tree_util.tree_map_with_path(
            lambda p, sd, n=n: jnp.asarray(leaf(n, p, sd), jnp.float32),
            tree) for n, tree in _templates(jcfg).items()}
    _DRAWS[key] = params
    return params


def trajectory(fields: dict, n_steps: int, seed: int = 0,
               batch_seed: int = 0, nudges: int = NUDGES,
               jax_init: bool = False) -> dict:
    """JAX's trajectory from draw(seed, jax_init) on synth_batches at
    `batch_seed`, and its envelope over `nudges` one-ulp nudges (also
    each nudge's own departures, under "nudged")."""
    jcfg, _ = configs(**fields)
    params = draw(jcfg, seed, jax_init)
    batches = synth_batches(n_steps, jcfg.batch_size, jcfg.fine_size,
                            batch_seed)
    ref = jax_run(fields, params, batches)
    envelope = {k: np.zeros(n_steps) for k in QUANTITIES}
    each = []
    for i in range(nudges):
        nudged = dict(params)
        for n in TRAINED:
            nudged[n] = nudge(params[n], i)
        each.append(departures(jax_run(fields, nudged, batches), ref))
        for k in envelope:
            envelope[k] = np.maximum(envelope[k], each[-1][k])
    return {"params": params, "batches": batches, "ref": ref,
            "envelope": envelope, "nudged": each}


def limits(tr: dict, factor: float = FACTOR) -> dict:
    """{quantity: per-step limit}: `factor` x JAX's envelope, where a loss's
    envelope is at least one f32 ulp of JAX's value (the nudges can leave
    a loss unchanged to the last bit, and no two sums in another order
    can promise better than its rounding)."""
    out = {}
    for k, env in tr["envelope"].items():
        if k in LOSSES:
            ref = np.abs([m[k] for m in tr["ref"]["losses"]]).astype(
                np.float32)
            env = np.maximum(env, np.spacing(ref).astype(np.float64))
        out[k] = factor * env
    return out


def excess(dep: dict, tr: dict, factor: float = FACTOR) -> dict:
    """{quantity: the largest ratio over the steps of the departure to
    its limit at `factor`} (above 1: out of the envelope)."""
    return {k: float(np.max(np.asarray(dep[k]) / lim))
            for k, lim in limits(tr, factor).items()}
