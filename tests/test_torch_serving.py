"""Port vs JAX: the two-stage inference and serving functions at the tiny
config, and the port's InferenceSession and MicroBatcher.

fake_B and fake_P must match to 1e-4 (the same f32 network arithmetic in
another summation order; the holes chain few attention steps).  The uint8
serving output floors (x+1)*127.5, so a value within 1e-4 of an integer
boundary may land one LSB apart: at most 1 LSB, on at most 0.1% of pixels.
"""

import threading

import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.serve.app import InferenceSession
from deepinpainting_torch.serve.batcher import MicroBatcher

from torch_port_helpers import configs, flat_dicts, jax_params, torch_models

TOL = dict(rtol=1e-4, atol=1e-4)
S = 64


def _requests(b, seed):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    mask = np.zeros((b, S, S), np.uint8)
    mask[0, 10:30, 34:50] = 1
    if b > 1:
        mask[1, 40:52, 8:30] = 1
        mask[1, 6:14, 6:14] = 1
    return gt, mask, ref


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, tcfg = configs()
    params = jax_params(jcfg, seed=3)
    flats = flat_dicts(params, tmp_path_factory.mktemp("w"))
    return params, flats


@pytest.mark.parametrize("mask_type", ["center", "random"])
def test_inference_and_serving_match_jax(weights, mask_type):
    params, flats = weights
    jcfg, tcfg = configs(mask_type=mask_type)
    tm = torch_models(tcfg, flats)
    gt, mask, ref = _requests(2, seed=7)
    jargs = (params["G"], params["P"], params["vgg"], gt, mask, ref)
    want_B, want_P = JI.make_inference_fn(jcfg)(*jargs)
    want_u8 = np.asarray(JI.make_serving_fn(jcfg)(*jargs))
    got_B, got_P = TI.make_inference_fn(tcfg, "cpu")(*tm, gt, mask, ref)
    got_u8 = TI.make_serving_fn(tcfg, "cpu")(*tm, gt, mask, ref).numpy()
    np.testing.assert_allclose(got_P.numpy(), np.asarray(want_P), **TOL)
    np.testing.assert_allclose(got_B.numpy(), np.asarray(want_B), **TOL)
    assert got_u8.dtype == np.uint8 and got_u8.shape == want_u8.shape
    diff = np.abs(got_u8.astype(np.int16) - want_u8.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_session_answers_requests(weights):
    _, flats = weights
    _, tcfg = configs()
    tm = torch_models(tcfg, flats)
    serve = TI.make_serving_fn(tcfg, "cpu")
    gt, mask, ref = _requests(2, seed=8)
    want = serve(*tm, gt, mask, ref).numpy()
    # one request at a time: the same batch-1 call, so the same bytes
    want1 = [serve(*tm, gt[i:i + 1], mask[i:i + 1], ref[i:i + 1]).numpy()
             for i in range(2)]

    single = InferenceSession(tcfg, state=tm, device="cpu")
    single.warmup()
    for i in range(2):
        out = single.run(gt[i:i + 1], mask[i:i + 1], ref[i:i + 1])
        assert out.dtype == np.uint8 and out.shape == (1, S, S, 3)
        np.testing.assert_array_equal(out, want1[i])
    assert single.calls == 3

    batched = InferenceSession(tcfg, state=tm, device="cpu", max_batch=4,
                               batch_wait_ms=200.0)
    try:
        results = [None] * 4
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, batched.run(gt[i % 2:i % 2 + 1], mask[i % 2:i % 2 + 1],
                           ref[i % 2:i % 2 + 1]))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for i, out in enumerate(results):
            assert out.shape == (1, S, S, 3)
            # a coalesced batch runs the same per-sample math; the CPU's
            # conv blocking depends on the batch size: 1 LSB at most
            np.testing.assert_allclose(out.astype(int), want[i % 2:i % 2 + 1],
                                       atol=1)
        assert batched._batcher.items_served == 4
        assert batched.calls == batched._batcher.batches_run < 4
    finally:
        batched.close()


def test_session_draws_weights_from_seed():
    _, tcfg = configs()
    a = InferenceSession(tcfg, device="cpu")
    b = InferenceSession(tcfg, device="cpu")
    for pa, pb in zip(a.state.G.parameters(), b.state.G.parameters()):
        assert torch.equal(pa, pb)
    assert not a.state.G.training


# ---- the port's MicroBatcher ------------------------------------------------

def test_batcher_roundtrip_and_no_padding():
    seen = []

    def fn(stacked):
        seen.append(stacked["x"].shape[0])
        return stacked["x"] * 2.0

    mb = MicroBatcher(fn, max_batch=8, wait_ms=1.0)
    try:
        out = mb.submit({"x": np.full((3,), 2.0, np.float32)})
        np.testing.assert_array_equal(out, np.full((3,), 4.0))
        assert seen == [1] and mb.batches_run == 1 and mb.items_served == 1
    finally:
        mb.close()


def test_batcher_coalesces_and_propagates_errors():
    def fn(stacked):
        if (stacked["x"] < 0).any():
            raise ValueError("negative")
        return stacked["x"] + 1.0

    mb = MicroBatcher(fn, max_batch=4, wait_ms=50.0)
    try:
        results, errors = {}, {}

        def call(i):
            try:
                results[i] = mb.submit({"x": np.full((2,), float(i))})
            except ValueError as e:
                errors[i] = e

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for i in range(4):
            np.testing.assert_array_equal(results[i], np.full((2,), i + 1.0))
        assert mb.items_served == 4 and mb.batches_run < 4
        with pytest.raises(ValueError):
            mb.submit({"x": np.full((2,), -1.0)})
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit({"x": np.zeros(2)})
