"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from the
repository root.  Tests that need a card are marked `gpu` and skip inside a
fixture where none is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(fine_size=64, ngf=8, ndf=8, vgg_width_scale=1 / 8, batch_size=2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


OPEN_LOOP = "serve-256-f32-open"     # the serving cell on an open loop


def tiny_cell(name: str):
    """The cell `name` with its traffic cut to a CPU test's size;
    OPEN_LOOP is the serving cell's session under drivers.open_loop."""
    from portbench import harness
    cell = harness.load_cell("serve-256-f32-sat" if name == OPEN_LOOP
                             else name)
    if cell.traffic["kind"] == "train":
        cell.traffic.update(pool_batches=4)
    else:
        cell.traffic.update(pool=16, sample=16, clients=8)
    if name == OPEN_LOOP:
        cell.traffic.update(kind="open", rate=40.0, senders=8)
    return cell
