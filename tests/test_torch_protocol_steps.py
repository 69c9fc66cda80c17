"""Port vs JAX: one train step of each single-flag quality protocol
(deepinpainting_torch/demo.py's `trunc`, `cosis` and `kr`: one reference
quirk corrected at a time), at the tiny config on the CPU.

tests/test_torch_train_step.py holds the shipped defaults and all three
quirks corrected together (through the lax attention); the protocols train
with one corrected at a time through the kernels' path, so each is held
here on its own, with the JAX step as its own tests run it: jitted, the
Pallas kernels in interpret mode (attention_impl='pallas', the default).
The same weights (numpy seed 7) and the batches of seed 13 and 113, on
which no protocol's first kbar has an entry within 1e-4 of a non-zero
integer (`risky`, tests/torch_port_helpers.py::run_both: `trunc` in the
faithful backward is discontinuous there; tests/torch_seed_scan.py 13 17
<flag>=False screened seeds 13-16 for each flag and found 13 and 15 free
of such entries).  Tolerances as in test_torch_train_step.py: metrics 1e-4
relative (the second step 3e-4), P, D and F gradients 1e-4, G's 1e-4 plus
1e-3 of the leaf's largest entry.

`kr` at batch seeds 15 and 19 (screened free of risky kbar entries too)
misses G's limit by 7.3x and 16.5x: there the generator has a ReLU input
within 3e-7 of zero, and the two packages' forwards, which agree to
rounding, put it on opposite sides.  test_kr_gap_is_one_relu_on_its_kink
holds both seeds to that account: with that one input's sign flipped
(a forward change below 6e-7) the port's gradients meet JAX's (at seed
15 to 1.05x the limit, the batch's own rounding envelope).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepinpainting_torch.models.unet_ipsr as U
from deepinpainting_torch.engine import inpaint as TI
from torch_port_helpers import (TRAINED as NETS, configs, flat_dicts,
                                jax_params, run_both, state_grads,
                                tiny_batch, torch_state)

METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")
FIELDS = dict(batch_size=2, use_dropout=False, mask_type="random")
PROTOCOL_FLAGS = {
    "trunc": dict(faithful_backward_truncation=False),
    "cosis": dict(faithful_detached_cosis=False),
    "kr": dict(faithful_known_replacement=False),
}
SEEDS = (13, 113)


def _limit_multiple(got, want):
    """The worst leaf's |got - want| as a multiple of G's limit."""
    return max(float((got[k] - want[k]).abs().max())
               / (1e-4 + 1e-3 * float(want[k].abs().max())) for k in want)


class _Relus:
    """torch.nn.functional in the generator's module, with its ReLU inputs
    recorded and, optionally, one element's sign flipped."""

    def __init__(self, flip=None):
        self.inputs, self.flip = [], flip

    def __getattr__(self, name):
        return getattr(F, name)

    def relu(self, x, *args, **kwargs):
        if self.flip is not None and self.flip[0] == len(self.inputs):
            delta = torch.zeros_like(x)
            delta[self.flip[1]] = -2 * x.detach()[self.flip[1]]
            x = x + delta
        self.inputs.append(x.detach().clone())
        return F.relu(x, *args, **kwargs)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, _ = configs(**FIELDS)
    params = jax_params(jcfg, seed=7)
    return params, flat_dicts(params, tmp_path_factory.mktemp("w"))


@pytest.fixture(scope="module", params=list(PROTOCOL_FLAGS))
def ran(request, weights):
    """Two steps of one protocol's configuration in both packages."""
    return run_both(dict(FIELDS, **PROTOCOL_FLAGS[request.param]), *weights,
                    seeds=SEEDS)


def test_the_flag_is_what_differs(ran):
    cfg = ran["tcfg"]
    quirks = (cfg.faithful_backward_truncation, cfg.faithful_detached_cosis,
              cfg.faithful_known_replacement)
    assert quirks.count(False) == 1 and cfg.attention_impl == "pallas"


def test_inputs_are_safe_to_truncate(ran):
    assert ran["risky"] == 0
    assert ran["kbar_max"] < 4


@pytest.mark.parametrize("name", METRICS)
def test_first_step_metric_matches(ran, name):
    got, want = float(ran["tm1"][name]), float(ran["jm1"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("net", NETS)
def test_gradients_match(ran, net):
    got, want = ran["tgrads"][net], ran["jgrads"][net]
    assert set(got) == set(want)
    total = 0.0
    for k in got:
        atol = 1e-4
        if net == "G":
            atol += 1e-3 * float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=f"{net}.{k}")
        total += float(want[k].abs().sum())
    assert total > 0


@pytest.mark.parametrize("name", METRICS)
def test_second_step_metric_matches(ran, name):
    np.testing.assert_allclose(float(ran["tm2"][name]),
                               float(ran["jm2"][name]), rtol=3e-4)


# batch seed: (a floor under G's limit multiple with the ReLU as the port
# has it (measured 7.27 and 16.48), the draw of the 1e-7 weight nudge
# that measures the batch's own rounding envelope; the draw is asserted
# to flip no ReLU)
KINK_SEEDS = {15: (7.0, 1), 19: (16.0, 2)}


@pytest.mark.parametrize("seed", list(KINK_SEEDS))
def test_kr_gap_is_one_relu_on_its_kink(weights, seed, monkeypatch):
    """With the generator's ReLU input nearest zero flipped, G's
    gradients meet JAX's within the limit, or within 1.1x the change that
    a 1e-7 relative nudge of the port's own G weights (flipping no ReLU)
    makes: measured 0.045x the limit at seed 19, and 1.05x at seed 15,
    where the nudge alone moves them by 1.05x."""
    fields = dict(FIELDS, **PROTOCOL_FLAGS["kr"])
    floor, draw = KINK_SEEDS[seed]
    relus = _Relus()
    monkeypatch.setattr(U, "F", relus)
    ran = run_both(fields, *weights, seeds=(seed, seed + 100))
    jgrads = ran["jgrads"]["G"]
    assert ran["risky"] == 0 and ran["kbar_max"] < 4
    assert _limit_multiple(ran["tgrads"]["G"], jgrads) > floor
    for net in ("P", "D", "F"):
        want = ran["jgrads"][net]
        for k, g in ran["tgrads"][net].items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4)
    # the generator's ReLU input nearest zero in the first step's forward
    first = relus.inputs[:len(relus.inputs) // 2]
    call = min(range(len(first)), key=lambda i: float(first[i].abs().min()))
    where = tuple(int(i) for i in np.unravel_index(
        int(first[call].abs().argmin()), first[call].shape))
    assert abs(float(first[call][where])) < 3e-7

    _, tcfg = configs(**fields)
    batch = tiny_batch(seed, tcfg.batch_size)

    def port_grads(relus, nudge=None):
        state = torch_state(tcfg, weights[1])
        if nudge is not None:
            with torch.no_grad():
                for p in state.G.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=nudge))
        monkeypatch.setattr(U, "F", relus)
        TI.make_train_step(tcfg, "cpu")(state, batch)
        return state_grads(state, "G")

    flipped = _limit_multiple(port_grads(_Relus(flip=(call, where))),
                              jgrads)
    nudged_relus = _Relus()
    nudged = _limit_multiple(
        port_grads(nudged_relus, torch.Generator().manual_seed(draw)),
        ran["tgrads"]["G"])
    assert all(torch.equal(a > 0, b > 0)
               for a, b in zip(first, nudged_relus.inputs))
    assert flipped <= max(1.0, 1.1 * nudged)
