"""The spatially partitioned train step (parallel/spatial.py::
make_dp_sp_train_step) on gloo ranks on the CPU against the port's
one-process step on the same global batch: the (2 data x 2 sp) grid and
the (1 x 2) one, in instance norm, norm='batch', grad_accum=2 and remat
at every level (whose recompute runs inside the spatial context).

Global batch 4 at the tiny config from the bridged weights of seed 9
and fresh Adam state, on test_torch_dp_step.py's screened batches; a
rank holds 2 (1 x 2: 4) rows, and 32 of their 64 rows.  use_dropout is
off, as in every parity test.

The rules are the JAX package's for its DP x SP step
(tests/test_parallel.py::test_dp_sp_train_step_matches_single and
test_dp_sp_batch_norm_stats_match_single): G_L1 and D within 5e-4
relative, G_GAN within 0.2, G's parameters after the step within 2.2 lr
of the one-process step's and more than 90% of them agreeing (Adam's
first update is +-lr, so a near-zero gradient can flip), running
statistics within 1e-3 (G, P) and 1e-2 (D) relative, 1e-4 absolute.
Adam's first update hides the gradients' scale, so the applied
gradients are held too, by test_torch_dp_step.py's rule: 1e-4 of the
leaf's largest entry plus 1e-6, and for G and P 8 times their chaos
envelope (the change of their gradients when the one-process step runs
with G's and P's first weights 1e-7 larger).  P's gradient is chaotic
too here: it comes from the L1 term alone, whose sign flips where fake_P
meets the image; the slabs' sums in another order flip a few (a 1e-7
nudge moves it by ~1e-3 of its largest entry, a 1e-6 one by ~1e-6).

The (2 x 2) cases in instance norm and norm='batch' are also held
against the JAX package's own make_dp_sp_train_step on a (2 x 2)
make_dp_sp_mesh of the virtual CPU devices, on the same bridged state
and batch, by the same rules of its tests/test_parallel.py: the losses,
G's parameters after the step and the running statistics.

The bf16 compute dtype runs on the 1 x 2 grid too: its losses within
1e-2 relative of the one-process bf16 step (bf16 rounds each conv's sums,
here in other orders on the slabs), and G's parameters by JAX's rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from deepinpainting_tpu import parallel as PP
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST
from deepinpainting_torch.convert.jax_bridge import bridge_tensors
from deepinpainting_torch.engine import inpaint as TI
from torch_port_helpers import (TRAINED, configs, flat_dicts, flat_of,
                                jax_params, state_grads, tiny_batch,
                                torch_state)

FIELDS = dict(batch_size=4, use_dropout=False, mask_type="random")
# case: (fields, batch seed, data groups, ranks)
CASES = {"instance_2x2": (dict(norm="instance"), 104, 2, 4),
         "instance_1x2": (dict(norm="instance"), 104, 1, 2),
         "batch_2x2": (dict(norm="batch"), 14, 2, 4),
         "grad_accum_2x2": (dict(norm="instance", grad_accum=2), 104, 2, 4),
         "remat_1x2": (dict(norm="instance", remat=True, remat_depth=0),
                       104, 1, 2)}
BF16_CASE = {"bf16_1x2": (dict(norm="instance", dtype="bfloat16"), 104,
                         1, 2)}
JAX_CASES = ("instance_2x2", "batch_2x2")
ENVELOPE_K = 8.0


def _jax_step(jcfg, params, batch, like, grid=None):
    """One step of the JAX package: make_dp_sp_train_step on the (n_data,
    n_sp) mesh `grid`, or its jitted one-device step.  Returns the metrics,
    and every trained network's parameters (and running statistics) after
    the step in the port's layout."""
    # a copy: the DP x SP step donates its state, and the parameters too
    state = JST.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.array, params))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if grid is None:
        step = jax.jit(JI.make_train_step(jcfg))
    else:
        mesh = PP.make_dp_sp_mesh(*grid)
        state = PP.replicate_state(state, mesh)
        batch = PP.place_spatial(batch, mesh, data_axis="data")
        step = PP.make_dp_sp_train_step(jcfg, mesh)
    out, metrics = step(state, batch, jax.random.PRNGKey(0))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "after": {n: bridge_tensors(flat_of(getattr(out, f"params_{n}")),
                                        getattr(like, n))
                      for n in TRAINED}}


def _run(case, tmp):
    kw, seed, n_data, world = {**CASES, **BF16_CASE}[case]
    jcfg, tcfg = configs(**dict(FIELDS, **kw))
    params = jax_params(jcfg, seed=9)
    flats = flat_dicts(params, tmp)
    batch = tiny_batch(seed, tcfg.batch_size)
    ranks = tmp / "ranks"
    ranks.mkdir()
    torch.save({"state": torch_state(tcfg, flats).state_dict(),
                "batch": batch}, ranks / "inputs.pt")
    W.run_ranks(W.sp_step, world, ranks, tcfg, n_data)
    out = {"cfg": tcfg, "ranks": [torch.load(ranks / f"rank{r}.pt",
                                             weights_only=False)
                                  for r in range(world)]}
    state = torch_state(tcfg, flats)
    _, metrics = TI.make_train_step(tcfg, "cpu")(state, batch)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = {n: state_grads(state, n) for n in TRAINED}
    out["after"] = {n: getattr(state, n).state_dict() for n in TRAINED}
    nudged = torch_state(tcfg, flats)
    with torch.no_grad():
        for net in (nudged.G, nudged.P):
            next(net.parameters()).mul_(1 + 1e-7)
    TI.make_train_step(tcfg, "cpu")(nudged, batch)
    if case in JAX_CASES:
        out["jax"] = _jax_step(jcfg, params, batch, state,
                               (n_data, world // n_data))
    if case == "batch_2x2":
        out["jax_one"] = _jax_step(jcfg, params, batch, state)
    out["envelope"] = {n: {k: float((g - out["grads"][n][k]).abs().max())
                           for k, g in state_grads(nudged, n).items()}
                       for n in ("G", "P")}
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
def test_ranks_hold_their_part_and_stay_replicas(runs, case):
    _, _, n_data, world = CASES[case]
    ran = runs(case)
    n_sp = world // n_data
    for r, res in enumerate(ran["ranks"]):
        assert res["grid"] == (n_data, n_sp, r // n_sp, r % n_sp)
        assert res["shape"] == (4 // n_data, 64 // n_sp, 64, 3)
        assert res["metrics"] == ran["ranks"][0]["metrics"]
        for net in TRAINED:
            for k, v in res["after"][net].items():
                assert torch.equal(v, ran["ranks"][0]["after"][net][k]), \
                    f"rank {r}: {net}.{k}"


@pytest.mark.parametrize("case", CASES)
def test_metrics_match_one_process_step(runs, case):
    ran = runs(case)
    got, want = ran["ranks"][0]["metrics"], ran["metrics"]
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    for k in ("G_L1", "D"):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, err_msg=k)
    np.testing.assert_allclose(got["G_GAN"], want["G_GAN"], rtol=0.2)


def _g_params(after, keys):
    """G's parameters (no running statistics) as one vector, in the order
    of `keys`."""
    return torch.cat([after[k].reshape(-1) for k in keys
                      if "running_" not in k and "num_batches" not in k])


@pytest.mark.parametrize("case", [*CASES, *BF16_CASE])
def test_g_parameters_match_one_process_step(runs, case):
    ran = runs(case)
    keys = list(ran["after"]["G"])
    a = _g_params(ran["ranks"][0]["after"]["G"], keys)
    b = _g_params(ran["after"]["G"], keys)
    assert float((a - b).abs().max()) <= 2.2 * ran["cfg"].lr
    agree = np.isclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5).mean()
    assert agree > 0.90, f"only {agree:.4%} of G's parameters agree"


@pytest.mark.parametrize("case", JAX_CASES)
def test_metrics_match_jax_dp_sp_step(runs, case):
    ran = runs(case)
    got, want = ran["ranks"][0]["metrics"], ran["jax"]["metrics"]
    assert set(got) == set(want)
    for k in ("G_L1", "D"):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, err_msg=k)
    np.testing.assert_allclose(got["G_GAN"], want["G_GAN"], rtol=0.2)


@pytest.mark.parametrize("case", JAX_CASES)
def test_g_parameters_match_jax_dp_sp_step(runs, case):
    ran = runs(case)
    keys = list(ran["after"]["G"])
    a = _g_params(ran["ranks"][0]["after"]["G"], keys)
    b = _g_params(ran["jax"]["after"]["G"], keys)
    assert float((a - b).abs().max()) <= 2.2 * ran["cfg"].lr
    agree = np.isclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5).mean()
    assert agree > 0.90, f"only {agree:.4%} of G's parameters agree"


# The running statistics on which the JAX package's (2 x 2) DP x SP step
# departs from its own one-device step at this size: netG's innermost
# level (1 x 1 rows at 64 px, too small to split), by 0.59 (mean) and 0.19
# (var) of the leaf's largest entry, where its (2 x 1) and (1 x 2) steps
# stay within 2e-6.  The port's grid is held to JAX's one-device step
# there.
JAX_SP_DEPARTS = {"G": {f"model{'.submodule' * 5}.up_norm3.{stat}"
                        for stat in ("running_mean", "running_var")},
                  "P": set(), "D": set()}


@pytest.mark.parametrize("net", ["G", "P", "D"])
def test_batch_norm_running_statistics_match_jax_dp_sp_step(runs, net):
    """By the rule of the JAX package's
    test_dp_sp_batch_norm_stats_match_single; on the leaves where JAX's
    DP x SP step departs from its one-device step (JAX_SP_DEPARTS, found
    here, not a tolerance), against that one-device step."""
    ran = runs("batch_2x2")
    got = ran["ranks"][0]["after"][net]
    sp, one = ran["jax"]["after"][net], ran["jax_one"]["after"][net]
    names = [k for k in got if "running_" in k]
    assert names and set(names) <= set(sp)
    rtol = 1e-2 if net == "D" else 1e-3
    close = dict(rtol=rtol, atol=1e-4)
    departs = {k for k in names
               if not np.allclose(sp[k].numpy(), one[k].numpy(), **close)}
    assert departs == JAX_SP_DEPARTS[net]
    for k in names:
        want = one[k] if k in departs else sp[k]
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), **close,
                                   err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", TRAINED)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_one_process_step(runs, case, net):
    """The gradients each phase applied: the grid's average of the ranks'
    is the one-process step's (a rank's loss is its data group's whole
    loss, so summing over sp alone would double them)."""
    ran = runs(case)
    got, want = ran["ranks"][0]["grads"][net], ran["grads"][net]
    assert set(got) == set(want)
    for k in got:
        atol = 1e-6 + 1e-4 * float(want[k].abs().max())
        if net in ran["envelope"]:
            atol += ENVELOPE_K * ran["envelope"][net][k]
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", ["G", "P", "D"])
def test_batch_norm_running_statistics_are_the_global_batch(runs, net):
    """G's and P's move once by the grid's moments (data x sp, every row
    of the global batch), D's four times by the data groups' (netD runs on
    the gathered image): as the one-process step moves them."""
    ran = runs("batch_2x2")
    got, want = ran["ranks"][0]["after"][net], ran["after"][net]
    names = [k for k in want if "running_" in k]
    assert names
    rtol = 1e-2 if net == "D" else 1e-3
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=1e-4, err_msg=f"{net}.{k}")
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k


def test_bf16_step_on_the_grid(runs):
    ran = runs("bf16_1x2")
    for res in ran["ranks"]:
        assert res["metrics"] == ran["ranks"][0]["metrics"]
        for net in TRAINED:
            for k, v in res["after"][net].items():
                assert torch.equal(v, ran["ranks"][0]["after"][net][k])
    got, want = ran["ranks"][0]["metrics"], ran["metrics"]
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)
