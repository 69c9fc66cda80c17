"""Rematerialisation (Config.remat / remat_depth) in the port.

A checkpointed U-Net level keeps no activations and runs its forward again
in the backward (models/remat.py).  The recompute replays the dropout draw
of the explicit generator and leaves the BatchNorm running statistics
alone, so a step with remat computes what the step without it computes.

Tolerances, and why:
  * port with remat against port without: bit for bit (losses, every
    gradient, every running statistic and the generator's state after the
    step).  On the CPU the recompute runs the same kernels on the same
    inputs in the same order, so nothing can differ;
  * port with remat against JAX with remat: the step's metrics within
    1e-4 relative, as test_torch_train_step.py holds the step without
    remat (f32 sums in another order), on a batch screened for entries
    `trunc` could flip (torch_port_helpers.run_both).
"""

import numpy as np
import pytest
import torch

from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.models.unet import UnetGenerator
from deepinpainting_torch.models.unet_ipsr import UnetGeneratorIPSR
from deepinpainting_torch.ops import attention as TA

from torch_port_helpers import (TRAINED, configs, flat_dicts, jax_params,
                                run_both, state_grads, state_tensors,
                                tiny_batch, torch_state)

METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")
FIELDS = dict(batch_size=2, mask_type="random")
VARIANTS = {"instance": dict(use_dropout=False),
            "batch+dropout": dict(norm="batch", use_dropout=True)}


def _levels(net):
    block, out = net.model, []
    while block is not None:
        out.append(block)
        block = block.submodule
    return out


@pytest.mark.parametrize("depth,want", [(1, 1), (2, 2), (0, None)])
def test_levels_are_numbered_from_the_outside(depth, want):
    """netP has num_downs levels, netG one more (its full-resolution
    outermost level), and the attention level is netG's level 3."""
    P = UnetGenerator(num_downs=6, ngf=8, remat=True, remat_depth=depth)
    G = UnetGeneratorIPSR(num_downs=6, ngf=8, remat=True,
                          remat_depth=depth)
    p_levels, g_levels = _levels(P), _levels(G)
    assert len(p_levels) == 6 and p_levels[-1].innermost
    assert len(g_levels) == 7 and g_levels[-1].innermost
    assert g_levels[3].with_attention
    for levels in (p_levels, g_levels):
        marked = [i for i, b in enumerate(levels) if b.remat]
        assert marked == list(range(want if want else len(levels)))
    assert not any(b.remat for b in _levels(UnetGenerator(num_downs=6,
                                                          ngf=8)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """norm -> (JAX parameters, the flat dicts the port loads)."""
    out = {}
    for norm in ("instance", "batch"):
        params = jax_params(configs(**FIELDS, norm=norm)[0], seed=7)
        out[norm] = params, flat_dicts(params, tmp_path_factory.mktemp(norm))
    return out


def _port_step(fields, flats, dropout_seed=11):
    """One port step; what it computed, the kbar builds it made, and the
    generator's state after it."""
    _, tcfg = configs(**fields)
    state = torch_state(tcfg, flats)
    gen = torch.Generator().manual_seed(dropout_seed)
    kbars, core = [], TA.attention_core_batched

    def spy(*a, **kw):
        out, kbar = core(*a, **kw)
        kbars.append(kbar)
        return out, kbar

    TA.attention_core_batched = spy
    try:
        _, metrics = TI.make_train_step(tcfg, "cpu")(state, tiny_batch(13),
                                                     gen)
    finally:
        TA.attention_core_batched = core
    return {"metrics": metrics, "kbars": kbars, "gen": gen.get_state(),
            "grads": {n: state_grads(state, n) for n in TRAINED},
            "tensors": {n: state_tensors(state, n) for n in TRAINED}}


@pytest.fixture(scope="module")
def port_runs(weights):
    out = {}
    for name, extra in VARIANTS.items():
        _, flats = weights[extra.get("norm", "instance")]
        fields = dict(FIELDS, **extra)
        out[name] = {depth: _port_step(
            dict(fields, remat=depth is not None, remat_depth=depth or 0),
            flats) for depth in (None, 1, 0)}
    return out


@pytest.mark.parametrize("depth", [1, 0])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_step_is_bit_identical(port_runs, variant, depth):
    base, got = port_runs[variant][None], port_runs[variant][depth]
    for k in METRICS:
        assert torch.equal(got["metrics"][k], base["metrics"][k]), k
    for n in TRAINED:
        for k, g in base["grads"][n].items():
            assert torch.equal(got["grads"][n][k], g), f"{n}.{k}"
        # parameters after Adam and, with norm='batch', the running
        # statistics and their counters (moved once a step, not twice)
        for k, t in base["tensors"][n].items():
            assert torch.equal(got["tensors"][n][k], t), f"{n}.{k}"
    assert torch.equal(got["gen"], base["gen"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_recompute_builds_the_same_kbar(port_runs, variant):
    """Each checkpointed level that encloses the attention level (levels
    0-3 of netG) recomputes it once more: remat_depth 1 builds kbar twice
    a step, remat_depth 0 five times (the forward, then the recomputes of
    levels 0, 1, 2 and 3, nested).  Every build has the same bits."""
    assert len(port_runs[variant][None]["kbars"]) == 1
    for depth, builds in ((1, 2), (0, 5)):
        kbars = port_runs[variant][depth]["kbars"]
        assert len(kbars) == builds
        assert all(torch.equal(k, kbars[0]) for k in kbars[1:])


def test_batch_norm_statistics_move_once_a_step(port_runs):
    tensors = port_runs["batch+dropout"][0]["tensors"]
    for n, want in (("G", 1), ("P", 1), ("D", 4)):
        counters = [v for k, v in tensors[n].items()
                    if k.endswith("num_batches_tracked")]
        assert counters and all(int(c) == want for c in counters), n


@pytest.fixture(scope="module")
def ran_jax(weights):
    """Both packages with remat at depth 1, from the same weights."""
    fields = dict(FIELDS, use_dropout=False, remat=True, remat_depth=1)
    return run_both(fields, *weights["instance"], seeds=(13, 113))


def test_jax_comparison_inputs_are_safe_to_truncate(ran_jax):
    assert ran_jax["risky"] == 0 and ran_jax["kbar_max"] < 4


@pytest.mark.parametrize("name", METRICS)
def test_remat_step_matches_jax_remat(ran_jax, name):
    got, want = float(ran_jax["tm1"][name]), float(ran_jax["jm1"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
