"""The port's 16-step training trajectory held to the JAX package's
within 8x JAX's own one-ulp envelope (tests/test_torch_trajectory.py
says how) for `kr`: known replacement off, unmasked positions keeping
their own feature in the attention."""

import torch_trajectory as TT

from test_torch_trajectory import BASE, BATCH_SEED, SEED, STEPS


def test_port_stays_in_jax_envelope():
    fields = dict(BASE, faithful_known_replacement=False)
    tr = TT.trajectory(fields, STEPS, SEED, BATCH_SEED)
    port = TT.port_run(fields, tr["params"], tr["batches"])
    ex = TT.excess(TT.departures(port, tr["ref"]), tr)
    assert max(ex.values()) <= 1.0, ex
