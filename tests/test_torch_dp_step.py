"""The data-parallel train step (parallel/mesh.py::make_dp_train_step) on
two gloo ranks on the CPU, against the port's one-process step and the
JAX package's single-device step on the same global batch.

The JAX package's data-parallel step is its single-device step on the
global batch compiled under SPMD (its own
test_dp_matches_single_device_grad_semantics equates the two), so both
references are one-device steps on the whole batch.  Global batch 4 at
the tiny config, 2 rows a rank (grad_accum=2: one row of each of the two
microbatches), from the bridged weights of seed 9 and fresh Adam state;
run_both gives both references on batches screened for kbar entries that
`trunc` could flip (test_torch_accum.py's seeds for instance norm, the
first passing seeds of test_torch_accum.py's scan for norm='batch').
use_dropout is off, as in every parity test.

Tolerances, and why:
  * metrics: 1e-5 relative against the port's one-process step (the same
    sums split over two ranks), 1e-3 against JAX (test_torch_accum.py's);
  * gradients of P, D and F: 1e-4 of the leaf's largest entry, plus 1e-6
    for leaves whose gradient is analytically zero (a bias that feeds a
    norm, D's head bias under the relativistic loss), where both steps
    return f32 rounding noise; against JAX 1e-4 absolute, the rule of
    test_torch_train_step.py;
  * gradients of G against the one-process step: P's rule plus 8 times
    the leaf's chaos envelope, the largest change of its gradient when the
    one-process step runs again with G's first weight 1e-7 larger
    (relative).  The attention recurrence amplifies rounding: with
    norm='batch' that change moves G's gradient by up to 1.7e-3 of a
    leaf's largest entry, and the data-parallel step's BatchNorm moments
    (the JAX layer's arithmetic) round differently from F.batch_norm's.
    8x the envelope is chip_smoke.py's rule for the scan on production
    holes;
  * gradients of G against JAX: 1e-4 plus 1e-3 of the leaf's largest
    entry (test_torch_train_step.py's rule);
  * running statistics: 1e-5 (test_torch_batchnorm.py's).
"""

import numpy as np
import pytest
import torch

import torch_dp_workers as W
from deepinpainting_torch.engine import inpaint as TI
from torch_port_helpers import (TRAINED, configs, flat_dicts, jax_params,
                                run_both, state_grads, tiny_batch,
                                torch_state)

FIELDS = dict(batch_size=4, use_dropout=False, mask_type="random")
CASES = {"instance": (dict(norm="instance"), (104, 378)),
         "batch": (dict(norm="batch"), (14, 17)),
         "grad_accum": (dict(norm="instance", grad_accum=2), (104, 378))}
METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")
ENVELOPE_K = 8.0


def _run(case, tmp):
    kw, seeds = CASES[case]
    fields = dict(FIELDS, **kw)
    jcfg, tcfg = configs(**fields)
    params = jax_params(jcfg, seed=9)
    flats = flat_dicts(params, tmp)
    ranks = tmp / "ranks"
    ranks.mkdir()
    torch.save({"state": torch_state(tcfg, flats).state_dict(),
                "batch": tiny_batch(seeds[0], tcfg.batch_size)},
               ranks / "inputs.pt")
    W.run_ranks(W.dp_step, 2, ranks, tcfg)
    out = run_both(fields, params, flats, seeds=seeds)
    nudged = torch_state(tcfg, flats)
    with torch.no_grad():
        next(nudged.G.parameters()).mul_(1 + 1e-7)
    TI.make_train_step(tcfg, "cpu")(nudged,
                                    tiny_batch(seeds[0], tcfg.batch_size))
    out["envelope"] = {k: float((g - out["tgrads"]["G"][k]).abs().max())
                       for k, g in state_grads(nudged, "G").items()}
    out["ranks"] = [torch.load(ranks / f"rank{r}.pt", weights_only=False)
                    for r in range(2)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case, tmp_path_factory.mktemp(case))
        return cache[case]
    return get


@pytest.mark.parametrize("case", CASES)
def test_inputs_are_safe_to_truncate(runs, case):
    ran = runs(case)
    assert ran["risky"] == 0 and ran["kbar_max"] < 4


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_half_the_rows_and_stay_replicas(runs, case):
    r0, r1 = runs(case)["ranks"]
    assert r0["rows"] == r1["rows"] == 2
    assert r0["metrics"] == r1["metrics"]
    for net in TRAINED:
        for k, v in r0["after"][net].items():
            assert torch.equal(v, r1["after"][net][k]), f"{net}.{k}"


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("case", CASES)
def test_metrics_match_one_process_step(runs, case, name):
    ran = runs(case)
    got = ran["ranks"][0]["metrics"][name]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(ran["tm1"][name]), rtol=1e-5)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("case", CASES)
def test_metrics_match_jax_step(runs, case, name):
    ran = runs(case)
    np.testing.assert_allclose(ran["ranks"][0]["metrics"][name],
                               float(ran["jm1"][name]), rtol=1e-3)


def _g_limit(want):
    return 1e-4 + 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("net", TRAINED)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_one_process_step(runs, case, net):
    ran = runs(case)
    got, want = ran["ranks"][0]["grads"][net], ran["tgrads"][net]
    assert set(got) == set(want)
    for k in got:
        atol = 1e-6 + 1e-4 * float(want[k].abs().max())
        if net == "G":
            atol += ENVELOPE_K * ran["envelope"][k]
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", TRAINED)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_step(runs, case, net):
    ran = runs(case)
    got, want = ran["ranks"][0]["grads"][net], ran["jgrads"][net]
    assert set(got) == set(want)
    for k in got:
        atol = _g_limit(want[k]) if net == "G" else 1e-4
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", ["G", "P", "D"])
def test_batch_norm_running_statistics_are_the_global_batch(runs, net):
    """G's and P's move once, D's four times, by the global batch's
    moments: as the one-process step moves them, and as JAX's."""
    ran = runs("batch")
    got = ran["ranks"][0]["after"][net]
    names = [k for k in ran["jafter"][net] if "running_" in k]
    assert names
    for k in names:
        assert not torch.equal(got[k], ran["before"][net][k])
        for want in (ran["after"][net][k], ran["jafter"][net][k]):
            np.testing.assert_allclose(got[k].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{net}.{k}")
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(v, ran["after"][net][k]), k
