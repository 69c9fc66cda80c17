"""A discrete event of the training loop that both packages cross, held
over the trajectory (tests/test_torch_trajectory.py holds the numpy
draws).

At JAX's own init_params at seed 0, `corrected` (no backward truncation,
the InnerCos losses in the graph) and synth_batches at seed 0, the port's
second step leaves 8x the envelope of JAX's first four one-ulp nudges
(G_L1 at 4.4x that limit).  The cause is in the first step: G's first
gradient departs from JAX's by 0.063 at its largest entry, where most
one-ulp nudges of JAX's weights move it by at most 5e-4 and three of
sixteen jump by 0.115-0.39: a near-tie of the loop that turns over, of
the kind JAX's own nudges turn over.  Against the envelope of all
sixteen nudges the port stays within 2x at every step of sixteen.
"""

import numpy as np

import torch_trajectory as TT

from test_torch_trajectory import BASE, PROTOCOLS, STEPS

FIELDS = dict(BASE, **PROTOCOLS["corrected"])
NUDGES = 16
FACTOR = 2.0


def test_step_two_event_is_crossed_by_jax_too():
    tr = TT.trajectory(FIELDS, STEPS, seed=0, batch_seed=0, nudges=NUDGES,
                       jax_init=True)
    dep = port = tr["ports"]["port"]
    # the first four nudges (the trajectory tests' envelope) miss it
    four = dict(tr, envelope={k: np.max([d[k] for d in tr["nudged"][:4]],
                                        axis=0) for k in TT.QUANTITIES})
    assert TT.excess(dep, four)["G_L1"] > 2.0
    # its cause: G's first gradient jumps, beyond the quiet nudges and
    # no further than JAX's own largest jump
    jumps = np.sort([d["grad_G"] for d in tr["nudged"]])
    assert dep["grad_G"] > 50 * np.median(jumps), (dep["grad_G"], jumps)
    assert dep["grad_G"] <= jumps[-1], (dep["grad_G"], jumps)
    # and over sixteen steps the port stays within 2x the envelope of
    # JAX's sixteen nudges, every loss and network at every step
    ex = TT.excess(dep, tr, FACTOR)
    assert len(port["losses"]) == STEPS
    assert max(ex.values()) <= 1.0, ex
