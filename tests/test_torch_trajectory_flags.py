"""The port's 16-step training trajectory held to the JAX package's
within 8x JAX's own one-ulp envelope (tests/test_torch_trajectory.py
says how) for two single-flag protocols: `trunc` (no backward
truncation) and `cosis` (the InnerCos losses in the graph);
tests/test_torch_trajectory_kr.py holds `kr` (known replacement off)."""

import pytest

import torch_trajectory as TT

from test_torch_trajectory import BASE, BATCH_SEED, SEED, STEPS

FLAGS = {
    "trunc": dict(faithful_backward_truncation=False),
    "cosis": dict(faithful_detached_cosis=False),
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_port_stays_in_jax_envelope(name):
    fields = dict(BASE, **FLAGS[name])
    tr = TT.trajectory(fields, STEPS, SEED, BATCH_SEED)
    port = TT.port_run(fields, tr["params"], tr["batches"])
    ex = TT.excess(TT.departures(port, tr["ref"]), tr)
    assert max(ex.values()) <= 1.0, (name, ex)
