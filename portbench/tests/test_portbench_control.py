"""The control of the correctness check, on the card at a small size: the
reference put in the program's place one precision below the
configuration's (f32 cells: TF32; bf16 cells: float8 conv operands) has to
fail one of the cell's numbers, while the program passes them.  On the
chip: python -m pytest portbench/tests -m gpu."""

import pytest

from portbench import calibrate, harness

SMALL = dict(fine_size=128, ngf=32, ndf=32, vgg_width_scale=0.5,
             batch_size=4)
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _fails(numbers, limits):
    """The compared numbers over their limits."""
    return [k for k, v in numbers.items() if k in limits
            and not v <= limits[k]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["train-256-f32", "train-512-bf16"])
def test_train_control_fails(card, name):
    cell = harness.load_cell(name)
    cell.traffic.update(pool_batches=4)
    cfg = harness.program_config(cell, **SMALL)
    for seed in SEEDS:
        row = calibrate.train_seed(cell, cfg, seed, card, True)
        assert not _fails(row["program"], cell.limits), row
        assert _fails(row["control"], cell.limits), row
        assert _fails(row["half_batch"], cell.limits), row


@pytest.mark.gpu
def test_serve_control_fails(card):
    cell = harness.load_cell("serve-256-f32-sat")
    cfg = harness.program_config(cell, **SMALL)
    for seed in SEEDS:
        row = calibrate.serve_seed(cell, cfg, seed, card, 1.0, True)
        assert not _fails(row["program"], cell.limits), row
        assert _fails(row["control"], cell.limits), row
