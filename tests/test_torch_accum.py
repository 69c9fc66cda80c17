"""Port vs JAX: the gradient-accumulated train step (Config.grad_accum).

k = 2 microbatches at batch 4, for norm='instance' and norm='batch', from
the same bridged weights, fresh Adam state and the same uint8 batches; the
JAX step (_make_accum_train_step) runs jitted, with the Pallas kernels in
interpret mode.  use_dropout=False for the comparison (the two frameworks'
generators cannot draw the same mask); the dropout replay has its own test.

Tolerances, and why:
  * the six metrics: 1e-3 relative (means over the microbatches of f32
    sums in another order);
  * gradients of P, D and F: 1e-4 absolute; G's: 1e-4 absolute plus 1e-3
    of the leaf's largest entry (test_torch_train_step.py's bound: lambda_A
    scales them to O(10)).  The JAX gradients are read back from Adam's
    first moment, g = mu / (1 - beta1);
  * parameter deltas of P, D and F after the step: 1e-4, on elements whose
    gradient is above 1e-5 (below it, lr * g / (|g| + eps) is rounding
    noise of any sign, as test_torch_train_step.py says);
  * running statistics after the step: 1e-5, as test_torch_batchnorm.py.
The batches are screened for kbar entries that `trunc` could flip.
"""

import numpy as np
import pytest
import torch

from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import attention as TA

from torch_port_helpers import (TRAINED, configs, flat_dicts, jax_params,
                                run_both, tiny_batch, torch_state)

K = 2
METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")
FIELDS = dict(batch_size=4, grad_accum=K, use_dropout=False,
              mask_type="random")
NORMS = ("instance", "batch")
# Batch seeds whose first step builds no kbar entry next to a non-zero
# integer (asserted below).  At batch 4 such entries are common: of the
# first 400 seeds, 2 pass with norm='instance' and the first 4 passing with
# norm='batch' come by seed 26 (the port's step alone, spying on
# attention_core_batched with torch_port_helpers.near_integer_entries).
SEEDS = {"instance": (104, 378), "batch": (14, 17)}


@pytest.fixture(scope="module", params=NORMS)
def ran(request, tmp_path_factory):
    fields = dict(FIELDS, norm=request.param)
    params = jax_params(configs(**fields)[0], seed=9)
    flats = flat_dicts(params, tmp_path_factory.mktemp(request.param))
    return run_both(fields, params, flats, seeds=SEEDS[request.param])


def test_inputs_are_safe_to_truncate(ran):
    assert ran["risky"] == 0 and ran["kbar_max"] < 4


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match(ran, name):
    got, want = float(ran["tm1"][name]), float(ran["jm1"][name])
    assert np.isfinite(got) and ran["tm1"][name].dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("net", TRAINED)
def test_gradients_match(ran, net):
    got, want = ran["tgrads"][net], ran["jgrads"][net]
    assert set(got) == set(want)
    for k in got:
        atol = 1e-4
        if net == "G":
            atol += 1e-3 * float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", ["P", "D", "F"])
def test_parameter_deltas_match(ran, net):
    for k, g in ran["tgrads"][net].items():
        sure = g.abs() > 1e-5
        got = ran["after"][net][k] - ran["before"][net][k]
        want = ran["jafter"][net][k] - ran["before"][net][k]
        np.testing.assert_allclose(got[sure].numpy(), want[sure].numpy(),
                                   rtol=0, atol=1e-4, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", ["G", "P", "D"])
def test_running_statistics_match(ran, net):
    """G's and P's move once a microbatch (in the D phase only), D's four
    times a microbatch (fake then real, in both phases)."""
    if ran["tcfg"].norm != "batch":
        assert not any("running_" in k for k in ran["after"][net])
        return
    names = [k for k in ran["jafter"][net] if "running_" in k]
    assert names
    for k in names:
        np.testing.assert_allclose(ran["after"][net][k].numpy(),
                                   ran["jafter"][net][k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{net}.{k}")
    counters = [v for k, v in ran["after"][net].items()
                if k.endswith("num_batches_tracked")]
    assert counters and all(int(c) == (4 * K if net == "D" else K)
                            for c in counters)


@pytest.fixture(scope="module")
def port_only(tmp_path_factory):
    """One port step with dropout, the recurrences and the forwards
    recorded."""
    fields = dict(FIELDS, use_dropout=True, norm="batch")
    jcfg, tcfg = configs(**fields)
    state = torch_state(tcfg, flat_dicts(jax_params(jcfg, seed=9),
                                         tmp_path_factory.mktemp("w")))
    calls = {"scan": 0, "core": 0, "fake_P": [], "fake_B": []}
    scan, core, fwd = (TA.scan_stream, TA.attention_core_batched,
                       TI.two_stage_forward)

    def count_scan(*a):
        calls["scan"] += 1
        return scan(*a)

    def count_core(*a, **kw):
        calls["core"] += 1
        return core(*a, **kw)

    def record(*a, **kw):
        out = fwd(*a, **kw)
        for key in ("fake_P", "fake_B"):
            calls[key].append(getattr(out, key).detach().clone())
        return out

    TA.scan_stream, TA.attention_core_batched = count_scan, count_core
    TI.two_stage_forward = record
    try:
        gen = torch.Generator().manual_seed(3)
        _, metrics = TI.make_train_step(tcfg, "cpu")(
            state, tiny_batch(13, 4), gen)
    finally:
        TA.scan_stream, TA.attention_core_batched = scan, core
        TI.two_stage_forward = fwd
    return calls, metrics, state, tcfg


def test_d_phase_takes_the_kbar_free_primal(port_only):
    """k forwards without a graph (a scan each, no kbar), then k forwards
    that are differentiated (a scan and a kbar each)."""
    calls, metrics, _, _ = port_only
    assert calls["core"] == K and calls["scan"] == 2 * K
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_g_phase_replays_each_microbatch_dropout_draw(port_only):
    """netP's output is the same bits in both phases.  fake_B agrees to
    rounding: the D phase's attention output is the scan's, the G phase's
    kbar @ P (as in the JAX package's primal and forward rule); another
    dropout mask would move it by O(1)."""
    calls = port_only[0]
    assert len(calls["fake_P"]) == len(calls["fake_B"]) == 2 * K
    for i in range(K):
        assert torch.equal(calls["fake_P"][i], calls["fake_P"][K + i])
        np.testing.assert_allclose(calls["fake_B"][K + i].numpy(),
                                   calls["fake_B"][i].numpy(), rtol=0,
                                   atol=1e-4)


def test_indivisible_batch_is_refused(port_only):
    _, _, state, tcfg = port_only
    step = TI.make_train_step(tcfg, "cpu")
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        step(state, tiny_batch(13, 3))
