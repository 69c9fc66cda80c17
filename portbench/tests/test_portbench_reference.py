"""The frozen reference against the program's CPU path at a tiny width,
from the same weights and inputs: the serving answers and the train step's
losses and updated parameters."""

import numpy as np
import pytest
import torch

from conftest import TINY
from portbench import harness, images
from portbench import weights as W
from portbench.reference import nets, step as R


@pytest.fixture(scope="module")
def setup():
    cell = harness.load_cell("train-256-f32")
    cfg = harness.program_config(cell, **TINY)
    dev = torch.device("cpu")
    pool = images.pool(21, 4, cfg.fine_size, dev)
    refs = images.ref_index(4)
    return cfg, dev, pool, refs


def _program(cfg, dev, train, seed=3):
    fam = harness.load_family("ipsr")
    progs = fam.networks(cfg, train=train)
    w = W.draw(W.shapes_of(progs), seed, dev, fam.leaf_std(cfg))
    harness._load(progs, w, dev)
    return progs, w


def test_serving_answers_equal(setup):
    from deepinpainting_torch.engine import inpaint as TI
    cfg, dev, pool, refs = setup
    progs, w = _program(cfg, dev, train=False)
    serve = TI.make_serving_fn(cfg, dev)
    got = serve(progs["G"].eval(), progs["P"].eval(), progs["vgg"].eval(),
                pool["image"], pool["mask"], pool["image"][refs]).numpy()
    want = R.serve(w, pool["image"], pool["mask"], pool["image"][refs],
                   R.config_dict(cfg), nets.Precision(), dev).numpy()
    assert got.shape == want.shape == (4, 64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 1e-3


def test_train_steps_agree(setup):
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.state import create_train_state
    cfg, dev, pool, refs = setup
    progs, w = _program(cfg, dev, train=True)
    state = create_train_state(cfg, *(progs[k] for k in "GPDF"),
                               progs["vgg"].eval())
    train_step = TI.make_train_step(cfg, dev)
    ref = R.TrainReference(w, R.config_dict(cfg), nets.Precision(), dev)
    for k in range(2):
        sl = slice(2 * k, 2 * k + 2)
        batch = {"image": pool["image"][sl], "mask": pool["mask"][sl],
                 "ref": pool["image"][refs[sl]]}
        state, m = train_step(state, batch)
        want = ref.step(batch)
        for name, v in want.items():
            assert float(m[name]) == pytest.approx(v, rel=1e-4, abs=1e-6)
    # each leaf's change within 1e-2 of the larger of its own and the
    # median leaf's change, over the leaves the reference moves by their
    # gradient: a leaf whose gradient is round-off (a bias ahead of an
    # instance norm) Adam moves by that round-off's sign, and the check
    # leaves it out by the same rule (compare.SMALL_GRAD)
    grads = R.leaf_norms(ref.first_grads)
    median_g = float(np.median(list(grads.values())))
    deltas = {}
    for net in R.TRAINED:
        for k, p in getattr(state, net).named_parameters():
            if grads[f"{net}.{k}"] >= 1e-3 * median_g:
                deltas[(net, k)] = (float((p.detach() - w[net][k]).norm()),
                                    float((ref.w[net][k].detach()
                                           - w[net][k]).norm()))
    assert len(deltas) > len(grads) // 2
    median_d = float(np.median([dr for _, dr in deltas.values()]))
    for key, (dp, dr) in deltas.items():
        assert abs(dp - dr) <= 1e-2 * max(dr, median_d), key

def test_reference_refuses_what_it_does_not_state(setup):
    cfg = setup[0]
    R.check_supported(cfg)
    with pytest.raises(ValueError):
        R.check_supported(cfg.replace(norm="batch"))
