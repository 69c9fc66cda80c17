"""The port's training trajectory held to the JAX package's over 16
steps (tests/torch_trajectory.py): the tiny configuration at batch 2,
the same starting weights in both packages, one stream of synthetic
batches (data/synth.py) into both packages' `make_train_step`, and at
every step the five losses and each trained network's parameters within
8x JAX's own envelope (the largest departure of JAX from itself over four
one-ulp nudges of its starting weights).  The training loop is chaotic
from the second step on (Adam's first update is +-lr on every weight, and
the sign of a near-zero gradient follows its last bits), so the envelope
is measured, not assumed.

Here the faithful protocol and `corrected` (no backward truncation, the
InnerCos losses in the graph), each with a control that must leave the
envelope: every Adam starting its count one step ahead.
tests/test_torch_trajectory_flags.py holds the single-flag protocols.

The weights are the protocols' distributions drawn by numpy at seed 0
(torch_trajectory.draw), the batches synth_batches' at seed 0.  A single
step can leave the four-nudge envelope through a discrete event of the
loop that JAX's own nudges also cross, only more rarely:
tests/test_torch_trajectory_events.py holds the one traced (JAX's own
init_params at seed 0, `corrected`, step 2).
"""

import pytest

import torch_trajectory as TT

STEPS = 16
SEED, BATCH_SEED = 0, 0
BASE = dict(batch_size=2, mask_type="random", attention_impl="lax")
PROTOCOLS = {
    "faithful": {},
    "corrected": dict(faithful_backward_truncation=False,
                      faithful_detached_cosis=False),
}


@pytest.fixture(scope="module", params=sorted(PROTOCOLS))
def run(request):
    fields = dict(BASE, **PROTOCOLS[request.param])
    return fields, TT.trajectory(fields, STEPS, SEED, BATCH_SEED, ports={
        "port": {}, "control": {"adam_count": 1}})


def test_port_stays_in_jax_envelope(run):
    fields, tr = run
    port = tr["ports"]["port"]
    ex = TT.excess(port, tr)
    assert len(port["losses"]) == STEPS
    assert max(ex.values()) <= 1.0, ex


def test_control_adam_count_off_by_one_leaves_envelope(run):
    """The same port run with every Adam one step ahead (bias
    corrections of step k + 1): the check above must refuse it."""
    fields, tr = run
    ex = TT.excess(tr["ports"]["control"], tr)
    assert max(ex.values()) > 1.0, ex
