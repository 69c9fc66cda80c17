"""Port vs JAX: the conv pack modes (Config.pack_small_cin, pack_out) of
deepinpainting_torch/ops/convs.py.

Each rewrite is an exact reassociation of the direct conv's sums, so it is
held to the direct conv at 1e-5 and its gradients at 1e-4 (the JAX
package's own limits, tests/test_convs.py), and to the JAX package's
packed function on the same inputs at 1e-5.  The gates are the JAX
package's.  At the 64 px test size pack_out never fires at the production
thresholds, so the model-level tests lower them in both packages, as the
JAX package's tests do.  The packed train step is held against JAX's
packed step on batches screened for `trunc` (torch_port_helpers.run_both).

The conv modes are held per thread; autograd may recompute a checkpointed
level in another thread than the forward's, and the recompute must take
the forward's packed paths (models/remat.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.ops import convs as JC
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.models.remat import checkpoint_level
from deepinpainting_torch.ops import convs as TC

from torch_port_helpers import (TRAINED, configs, flat_dicts, jax_params,
                                nchw, run_both, tiny_batch, torch_models,
                                torch_state)

METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")
REWRITES = ("_conv2d_space_to_depth", "_conv2d_tap_stack",
            "_conv2d_hpack2", "_deconv_dpack4")
LOWERED = {"_PACK_OUT_MIN_HW": 16, "_PACK_OUT_MIN_CIN": 4}


def _direct_and_packed(name):
    """(x NHWC, JAX kernel HWIO, the JAX direct and packed functions, the
    port's direct and packed functions on NCHW / torch layouts)."""
    rng = np.random.default_rng(20 + CASES.index(name))
    if name == "_conv2d_space_to_depth":
        x, k = (2, 16, 14, 3), (4, 4, 3, 8)
        jd = lambda x, k: JC.conv2d(x, k, None, 2, 1)
        jp = lambda x, k: JC._conv2d_space_to_depth(x, k, 2, 1)
        td = lambda x, w: torch.nn.functional.conv2d(x, w, None, 2, 1)
        tp = lambda x, w: TC._conv2d_space_to_depth(x, w, 1)
    elif name == "_conv2d_tap_stack":
        x, k = (2, 12, 10, 3), (3, 3, 3, 8)
        jd = lambda x, k: JC.conv2d(x, k, None, 1, 1)
        jp = lambda x, k: JC._conv2d_tap_stack(x, k, 1)
        td = lambda x, w: torch.nn.functional.conv2d(x, w, None, 1, 1)
        tp = lambda x, w: TC._conv2d_tap_stack(x, w, 1)
    elif name == "_conv2d_hpack2":
        x, k = (2, 20, 14, 33), (3, 3, 33, 9)
        jd = lambda x, k: JC.conv2d(x, k, None, 1, 1)
        jp = JC._conv2d_hpack2
        td = lambda x, w: torch.nn.functional.conv2d(x, w, None, 1, 1)
        tp = TC._conv2d_hpack2
    elif name == "_deconv_dpack4":
        x, k = (2, 9, 7, 34), (4, 4, 34, 6)
        jd = lambda x, k: JC.conv_transpose2d(x, k, None, 2, 1)
        jp = JC._deconv_dpack4
        td = lambda x, w: torch.nn.functional.conv_transpose2d(x, w, None,
                                                               2, 1)
        tp = TC._deconv_dpack4
    else:   # the k3s1p1 deconv: hpack2 of the flipped, transposed kernel
        x, k = (2, 12, 10, 35), (3, 3, 35, 5)
        jd = lambda x, k: JC.conv_transpose2d(x, k, None, 1, 1)
        jp = lambda x, k: JC._conv2d_hpack2(x, jnp.flip(k, axis=(0, 1)))
        td = lambda x, w: torch.nn.functional.conv_transpose2d(x, w, None,
                                                               1, 1)
        tp = lambda x, w: TC._conv2d_hpack2(x, w.flip(2, 3).transpose(0, 1))
    x = rng.standard_normal(x).astype(np.float32)
    k = (0.1 * rng.standard_normal(k)).astype(np.float32)
    # torch layouts: ConvTranspose2d [Cin, Cout, kh, kw], Conv2d [Cout,
    # Cin, kh, kw]
    w = (k.transpose(2, 3, 0, 1) if "deconv" in name
         else k.transpose(3, 2, 0, 1))
    return x, k, torch.from_numpy(np.ascontiguousarray(w)), jd, jp, td, tp


CASES = REWRITES + ("k3s1_deconv",)


@pytest.mark.parametrize("name", CASES)
def test_rewrite_matches_the_direct_conv(name):
    x, _, w, _, _, td, tp = _direct_and_packed(name)
    xs = nchw(x).requires_grad_(True)
    ws = w.clone().requires_grad_(True)
    direct = td(xs, ws)
    packed = tp(xs, ws)
    assert packed.shape == direct.shape
    np.testing.assert_allclose(packed.detach().numpy(),
                               direct.detach().numpy(), rtol=1e-5, atol=1e-5)
    gd = torch.autograd.grad(direct.square().sum(), (xs, ws))
    gp = torch.autograd.grad(packed.square().sum(), (xs, ws))
    for a, b in zip(gp, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", CASES)
def test_rewrite_matches_the_jax_packed_function(name):
    x, k, w, jd, jp, _, tp = _direct_and_packed(name)
    want = np.asarray(jp(jnp.asarray(x), jnp.asarray(k))).transpose(0, 3, 1, 2)
    got = tp(nchw(x), w).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and JAX's packed function is its direct conv here too
    np.testing.assert_allclose(
        want, np.asarray(jd(jnp.asarray(x), jnp.asarray(k))).transpose(
            0, 3, 1, 2), rtol=1e-5, atol=1e-5)


def test_pack_small_cin_gates():
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 16)).astype(
        np.float32)).permute(0, 3, 1, 2)
    w = torch.from_numpy(rng.standard_normal((8, 16, 4, 4)).astype(
        np.float32))
    assert TC._packed_small_cin(x, w, 2, 1, 1) is None      # Cin > 8
    x3, w3 = x[:, :3], w[:, :3]
    assert TC._packed_small_cin(x3, w3, 2, 1, 1) is not None   # s2d
    assert TC._packed_small_cin(x3, w3, 1, 1, 1) is not None   # taps
    assert TC._packed_small_cin(x3, w3, 2, 1, 2) is None    # dilated
    assert TC._packed_small_cin(x3, w3[:, :, :1, :1], 1, 0, 1) is None
    assert TC._packed_small_cin(x3, w3[:, :, :3], 1, 1, 1) is None  # 3x4
    assert TC._packed_small_cin(x3[:, :, :15, :15], w3, 2, 1, 1) is None
    assert TC._packed_small_cin(x3, w3[:, :, :3, :3], 2, 1, 1) is None  # k3s2


def test_pack_out_gates():
    rng = np.random.default_rng(23)
    hw = TC._PACK_OUT_MIN_HW
    x = torch.from_numpy(rng.standard_normal((1, 64, hw, hw)).astype(
        np.float32))
    k3 = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(
        np.float32))
    assert TC._packed_out_conv(x, k3, 1, 1, 1) is not None     # eligible
    assert TC._packed_out_conv(x, k3, 2, 1, 1) is None         # strided
    assert TC._packed_out_conv(x, k3, 1, 1, 2) is None         # dilated
    assert TC._packed_out_conv(x[:, :, :hw // 2], k3, 1, 1, 1) is None
    assert TC._packed_out_conv(x[:, :8], k3[:, :8], 1, 1, 1) is None
    assert TC._packed_out_conv(x[:, :, :hw - 1], k3, 1, 1, 1) is None
    k4 = torch.from_numpy(rng.standard_normal((64, 64, 4, 4)).astype(
        np.float32))                                           # [Cin, Cout]
    assert TC._packed_out_deconv(x, k4, 2, 1) is not None      # eligible
    assert TC._packed_out_deconv(x, k4, 1, 1) is None          # k4 s1
    wide = torch.zeros((64, 65, 4, 4))
    assert TC._packed_out_deconv(x, wide, 2, 1) is None        # Cout > 64
    assert TC._packed_out_deconv(x[:, :, :16, :16], k4, 2, 1) is None
    assert TC._packed_out_deconv(x, k3, 1, 1) is not None      # k3s1
    assert TC._packed_out_deconv(x, k3, 1, 0) is None          # padding 0


def _spy(monkeypatch):
    """Count each rewrite's calls (the routing looks them up by name)."""
    calls = {n: 0 for n in REWRITES}
    for n in REWRITES:
        def wrapped(*a, _n=n, _f=getattr(TC, n)):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(TC, n, wrapped)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_order_int8_then_small_cin_then_pack_out(monkeypatch, dtype):
    """A conv eligible for several modes takes the first in the JAX
    package's order, in f32 and in bf16, and the result stays in the
    input's dtype."""
    monkeypatch.setattr(TC, "_PACK_OUT_MIN_HW", 8)
    monkeypatch.setattr(TC, "_PACK_OUT_MIN_CIN", 4)
    calls = _spy(monkeypatch)
    torch.manual_seed(0)
    wide = TC.Conv2d(32, 32, 3, 1, 1)      # int8 and pack_out
    small = TC.Conv2d(6, 16, 3, 1, 1)      # pack_small_cin and pack_out
    up = TC.ConvTranspose2d(32, 16, 4, 2, 1)   # int8 and pack_out
    x32, x6 = torch.randn(1, 32, 8, 8, dtype=dtype), torch.randn(
        1, 6, 8, 8, dtype=dtype)
    every = TC.ConvModes(int8=True, pack_small_cin=True, pack_out=True)
    with torch.no_grad(), TC.use_modes(every):
        outs = [wide(x32), small(x6), up(x32)]
    assert calls == {"_conv2d_space_to_depth": 0, "_conv2d_tap_stack": 1,
                     "_conv2d_hpack2": 0, "_deconv_dpack4": 0}
    assert all(o.dtype == dtype for o in outs)
    with torch.no_grad(), TC.use_modes(TC.ConvModes(pack_out=True)):
        packed = [wide(x32), small(x6), up(x32)]
    assert calls["_conv2d_hpack2"] == 2 and calls["_deconv_dpack4"] == 1
    with torch.no_grad():
        direct = [wide(x32), small(x6), up(x32)]
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for a, b in zip(packed, direct):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, _ = configs(batch_size=2, mask_type="random", use_dropout=False)
    params = jax_params(jcfg, seed=7)
    return params, flat_dicts(params, tmp_path_factory.mktemp("w"))


@pytest.mark.parametrize("modes", [dict(pack_small_cin=True),
                                   dict(pack_out=True),
                                   dict(pack_small_cin=True, pack_out=True)])
def test_inference_with_the_modes_on_matches_off(weights, monkeypatch,
                                                 modes):
    for name, value in LOWERED.items():
        monkeypatch.setattr(TC, name, value)
    calls = _spy(monkeypatch)
    _, tcfg = configs(batch_size=2, mask_type="random", is_train=False)
    models = torch_models(tcfg, weights[1])
    batch = tiny_batch(21)
    args = (batch["image"], batch["mask"], batch["ref"])
    off = TI.make_inference_fn(tcfg, "cpu")(*models, *args)
    assert not any(calls.values())
    on = TI.make_inference_fn(tcfg.replace(**modes), "cpu")(*models, *args)
    # every rewrite the modes select fires inside the real networks
    fired = {n for n, c in calls.items() if c}
    want = set()
    if modes.get("pack_small_cin"):
        want |= {"_conv2d_space_to_depth", "_conv2d_tap_stack"}
    if modes.get("pack_out"):
        want |= {"_conv2d_hpack2", "_deconv_dpack4"}
    assert fired == want
    for a, b in zip(on, off):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def packed_step(weights):
    """Two packed train steps in both packages, both modes on and the
    thresholds lowered on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in LOWERED.items():
            mp.setattr(TC, name, value)
            mp.setattr(JC, name, value)
        return run_both(dict(batch_size=2, mask_type="random",
                             use_dropout=False, pack_small_cin=True,
                             pack_out=True), *weights, seeds=(13, 113))


def test_packed_step_inputs_are_safe_to_truncate(packed_step):
    assert packed_step["risky"] == 0 and packed_step["kbar_max"] < 4


@pytest.mark.parametrize("name", METRICS)
def test_packed_step_matches_jax_packed_step(packed_step, name):
    for step in ("1", "2"):
        got = float(packed_step["tm" + step][name])
        want = float(packed_step["jm" + step][name])
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want,
                                   rtol=1e-4 if step == "1" else 3e-4)


@pytest.mark.parametrize("net", TRAINED)
def test_packed_step_gradients_match_jax(packed_step, net):
    """test_torch_train_step.py's limits: 1e-4, plus 1e-3 of a leaf's
    largest entry for G."""
    got, want = packed_step["tgrads"][net], packed_step["jgrads"][net]
    assert set(got) == set(want)
    for k in got:
        atol = 1e-4 + (1e-3 * float(want[k].abs().max()) if net == "G"
                       else 0.0)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("extra", [dict(grad_accum=2),
                                   dict(remat=True, remat_depth=0)])
def test_packed_accum_and_remat_steps_match_unpacked(weights, monkeypatch,
                                                     extra):
    """The G phase's re-run under grad_accum and the recompute of every
    checkpointed level take the packed paths too; the step with both modes
    on matches the step with them off (1e-4 relative on the metrics)."""
    for name, value in LOWERED.items():
        monkeypatch.setattr(TC, name, value)
    calls = _spy(monkeypatch)
    metrics = {}
    for packed in (False, True):
        _, tcfg = configs(batch_size=2, mask_type="random", use_dropout=False,
                          pack_small_cin=packed, pack_out=packed, **extra)
        state = torch_state(tcfg, weights[1])
        before = dict(calls)
        _, metrics[packed] = TI.make_train_step(tcfg, "cpu")(
            state, tiny_batch(13))
        fired = sum(calls.values()) - sum(before.values())
        assert (fired > 0) == packed
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[True][k]),
                                   float(metrics[False][k]), rtol=1e-4)


def test_recompute_in_another_thread_takes_the_packed_path(monkeypatch):
    """The backward of a checkpointed level runs in a thread that never
    entered the modes; its recompute still takes the forward's packed path,
    and the gradients equal those of the same packed forward without
    checkpointing bit for bit."""
    monkeypatch.setattr(TC, "_PACK_OUT_MIN_HW", 8)
    where = []
    hpack = TC._conv2d_hpack2

    def spy(x, w):
        where.append(threading.current_thread().name)
        return hpack(x, w)

    monkeypatch.setattr(TC, "_conv2d_hpack2", spy)
    torch.manual_seed(0)
    conv = TC.Conv2d(32, 16, 3, 1, 1)
    x = torch.randn(2, 32, 8, 8)
    fn = lambda t: conv(t).square()
    packed = TC.ConvModes(pack_out=True)

    def grads(checkpointed):
        xs = x.clone().requires_grad_(True)
        with TC.use_modes(packed):
            y = checkpoint_level(conv, fn, xs, None) if checkpointed \
                else fn(xs)
        out = []
        t = threading.Thread(target=lambda: out.append(torch.autograd.grad(
            y.sum(), (xs, conv.weight))), name="backward")
        t.start()
        t.join(60)
        assert not t.is_alive() and len(out) == 1
        return out[0]

    plain = grads(False)
    assert where == ["MainThread"]
    remat = grads(True)
    assert where[1:] == ["MainThread", "backward"]
    for a, b in zip(remat, plain):
        assert torch.equal(a, b)
