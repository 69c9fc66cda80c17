"""Port vs JAX: the bf16 compute dtype (Config.dtype='bfloat16').

Both packages keep f32 parameters and compute netP and netG in bf16: the
inputs are cast at the two-stage boundary, convs cast their weights per
call, norms keep f32 statistics, the attention computes in f32 inside, and
fake_B, the taps, the losses and the metrics come back in f32.

A bf16 result cannot match another bf16 implementation closely: each
layer rounds to 8 significant bits, and on the CPU the two frameworks'
convs accumulate differently (the JAX package's convs.py warns so).  So
each result is held to bf16's own effect, measured in the JAX package on
the same inputs and weights:

  * max|port bf16 - JAX bf16| <= 2 * max|JAX bf16 - JAX f32|, and the
    same for the mean over elements, for every output of the two-stage
    forward (fake_P, fake_B, both taps), the inference function, the eval
    step (images, losses, per-image PSNR and SSIM) and the coarse
    function;
  * and max|port bf16 - JAX bf16| <= 5e-2 for every output but fake_B and
    the taps.  Theirs cannot be: bf16's own effect on them is 1.75-2.5 at
    the max and 0.03-0.18 in the mean in the JAX package itself on these
    inputs, from instance norms over 2x2 maps at this 64 px size (which
    divide bf16 rounding by a small spread) and, in the inference
    function, where VGG runs in bf16 too, from the attention's argmax
    choosing other patches.

The attention alone (bf16 in, f32 inside, bf16 out, and its backward) gets
the same inputs on both sides and agrees to a bf16 rounding step.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.models.vgg16 import apply_vgg16
from deepinpainting_tpu.ops import attention as JA
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import attention as TA

from torch_port_helpers import (TRAINED, configs, flat_dicts, jax_params,
                                nchw, nhwc, tiny_batch, torch_state)

FIELDS = dict(batch_size=2, use_dropout=False, mask_type="random")
DTYPES = ("float32", "bfloat16")
# (entry, output); the 5e-2 limit holds for all but netG's images and taps
OUTPUTS = [("forward", "fake_P"), ("forward", "fake_B"),
           ("forward", "inner_cos"), ("forward", "inner_cos2"),
           ("inference", "fake_B"), ("inference", "fake_P"),
           ("eval", "fake_B"), ("eval", "fake_P"), ("eval", "loss_valid"),
           ("eval", "loss_ipsr"), ("eval", "psnr"), ("eval", "ssim"),
           ("coarse", "fake_P"), ("coarse", "composite")]
NETG_OUTPUTS = ("fake_B", "inner_cos", "inner_cos2")


def _jax_results(jcfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gt = jb["image"].astype(jnp.float32) / 127.5 - 1.0
    mask = jb["mask"].astype(jnp.float32)
    _, flag = JI.prepare_masks(jcfg, mask)
    ref_feat = apply_vgg16(params["vgg"], jb["ref"].astype(jnp.float32)
                           / 127.5 - 1.0, jcfg.vgg_width_scale).relu4_3
    models = JI.build_models(jcfg)
    dt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32
    fwd = jax.jit(lambda g, p: JI.two_stage_forward(
        models, g, p, gt, mask, ref_feat, flag, train=False,
        rng=jax.random.PRNGKey(0), dtype=dt)[:3])(params["G"], params["P"])
    ev = jax.jit(JI.make_eval_step(jcfg))(
        JST.create_train_state(jcfg, params), jb)
    inf = jax.jit(JI.make_inference_fn(jcfg))(
        params["G"], params["P"], params["vgg"], jb["image"], jb["mask"],
        jb["ref"])
    co = jax.jit(JI.make_coarse_fn(jcfg))(params["P"], jb["image"],
                                          jb["mask"])
    out = {"forward": {"fake_P": fwd[0], "fake_B": fwd[1], **fwd[2]},
           "inference": {"fake_B": inf[0], "fake_P": inf[1]},
           "eval": {k: ev[k] for k in ("fake_B", "fake_P", "loss_valid",
                                       "loss_ipsr", "psnr", "ssim")},
           "coarse": {"fake_P": co[0], "composite": co[1]}}
    inputs = (nchw(gt), torch.from_numpy(np.array(mask)), nchw(ref_feat),
              torch.from_numpy(np.array(flag)))
    return ({e: {k: np.asarray(v, np.float64) for k, v in d.items()}
             for e, d in out.items()}, inputs)


def _port_results(tcfg, state, batch, inputs):
    G, P, vgg = state.G.eval(), state.P.eval(), state.vgg
    gt, mask, ref_feat, flag = inputs
    with torch.no_grad():
        fwd = TI.two_stage_forward(G, P, gt, mask, ref_feat, flag,
                                   dtype=TI.compute_dtype(tcfg))
    ev = TI.make_eval_step(tcfg, "cpu")(state, batch)
    inf = TI.make_inference_fn(tcfg, "cpu")(G, P, vgg, batch["image"],
                                            batch["mask"], batch["ref"])
    co = TI.make_coarse_fn(tcfg, "cpu")(P, batch["image"], batch["mask"])
    nhwc_ = lambda t: t.permute(0, 2, 3, 1)
    return {"forward": {"fake_P": nhwc_(fwd.fake_P),
                        "fake_B": nhwc_(fwd.fake_B),
                        **{k: nhwc_(v) for k, v in fwd.taps.items()}},
            "inference": {"fake_B": inf[0], "fake_P": inf[1]},
            "eval": {k: ev[k] for k in ("fake_B", "fake_P", "loss_valid",
                                        "loss_ipsr", "psnr", "ssim")},
            "coarse": {"fake_P": co[0], "composite": co[1]}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """dtype -> (JAX results, the port's), weights and batch of
    test_torch_eval.py."""
    jcfg, tcfg = configs(**FIELDS)
    params = jax_params(jcfg, seed=3)
    state = torch_state(tcfg, flat_dicts(params,
                                         tmp_path_factory.mktemp("w")))
    batch = tiny_batch(21)
    out = {}
    for name in DTYPES:
        jout, inputs = _jax_results(jcfg.replace(dtype=name), params, batch)
        out[name] = jout, _port_results(tcfg.replace(dtype=name), state,
                                        batch, inputs)
    return out


@pytest.mark.parametrize("entry,key", OUTPUTS)
def test_bf16_within_its_own_effect(results, entry, key):
    jax_f32 = results["float32"][0][entry][key]
    jax_bf16 = results["bfloat16"][0][entry][key]
    port_t = results["bfloat16"][1][entry][key]
    assert port_t.dtype == torch.float32, "results come back in f32"
    port = port_t.detach().numpy().astype(np.float64)
    assert port.shape == jax_bf16.shape and np.isfinite(port).all()
    own = np.abs(jax_bf16 - jax_f32)
    d = np.abs(port - jax_bf16)
    assert own.max() > 0, "the bf16 path must differ from the f32 one"
    assert d.max() <= 2 * own.max(), (d.max(), own.max())
    assert d.mean() <= 2 * own.mean(), (d.mean(), own.mean())
    if key not in NETG_OUTPUTS:
        assert d.max() <= 5e-2, d.max()


@pytest.mark.parametrize("entry,key", OUTPUTS)
def test_f32_is_unchanged_by_the_boundary(results, entry, key):
    """With dtype='float32' the casts are no-ops: the f32 parity of the
    earlier tests (1e-4) holds on the same outputs."""
    jax_f32 = results["float32"][0][entry][key]
    port = results["float32"][1][entry][key].detach().numpy()
    tol = 1e-3 if key in ("loss_valid", "psnr") else 1e-4
    np.testing.assert_allclose(port, jax_f32, rtol=0, atol=tol)


@pytest.mark.parametrize("backward", [False, True])
def test_attention_bf16_matches_jax(backward):
    """bf16 feature in, f32 prep / scan / kbar, bf16 out; the backward's
    K^T g in f32, cast to the cotangent's dtype.  Same bf16 inputs on both
    sides, so the results differ by at most a bf16 rounding step."""
    rng = np.random.default_rng(14)
    b, h, w, c = 3, 8, 8, 16
    feat = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.bfloat16)
    ref = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.bfloat16)
    flag = np.zeros((b, h * w), np.float32)
    flag[0, 18:27], flag[1, ::8], flag[2, 50:53] = 1, 1, 1
    g = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.bfloat16)
    tf = lambda a: nchw(np.asarray(a, np.float32)).to(torch.bfloat16)
    x = tf(feat).requires_grad_(backward)
    out = TA.ipsr_attention_batched(x, tf(ref), torch.from_numpy(flag),
                                    triple_weight=0.7,
                                    truncate_backward=False)
    want, vjp = jax.vjp(lambda f: JA.ipsr_attention_batched(
        f, ref, jnp.asarray(flag), 0.7, False, "pallas", True), feat)
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    pairs = [(out, want)]
    if backward:
        out.backward(tf(g))
        want_grad, = vjp(g)
        assert x.grad.dtype == torch.bfloat16
        pairs.append((x.grad, want_grad))
    for got, ref_ in pairs:
        ref_ = np.asarray(ref_, np.float32)
        np.testing.assert_allclose(nhwc(got.float()), ref_, rtol=2 ** -7,
                                   atol=1e-3 * np.abs(ref_).max())


# sha256 (first 16 hex digits) of "key shape dtype" lines of each network's
# state_dict at the 64 px tiny config, as the port built them before the
# compute dtype and remat: the weight bridge and saved checkpoints rely on
# these names.
STATE_DICT_DIGESTS = {
    "instance": {"G": "1539ab6ca9e0e696", "P": "5890b6412c86ec44",
                 "vgg": "b064fcd2e931a40b", "D": "b8f9e2dd5bed7fa5",
                 "F": "c6771f71bc139fe6"},
    "batch": {"G": "24b086000e3369a2", "P": "815aeb497271bf62",
              "vgg": "b064fcd2e931a40b", "D": "4f1b1320e467cac4",
              "F": "c6771f71bc139fe6"},
}


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("extra", [
    {}, dict(dtype="bfloat16", remat=True, remat_depth=0, grad_accum=2)])
def test_state_dict_keys_are_unchanged(norm, extra):
    _, tcfg = configs(norm=norm, **extra)
    nets = dict(zip(("G", "P", "vgg"), TI.build_models(tcfg)))
    nets.update(zip(("D", "F"), TI.build_discriminators(tcfg)))
    for name, net in nets.items():
        lines = "\n".join(f"{k} {tuple(v.shape)} {v.dtype}"
                          for k, v in net.state_dict().items())
        digest = hashlib.sha256(lines.encode()).hexdigest()[:16]
        assert digest == STATE_DICT_DIGESTS[norm][name], name


@pytest.fixture(scope="module")
def bf16_steps(tmp_path_factory):
    """One bf16 train step, with and without remat, from the same
    weights."""
    fields = dict(FIELDS, norm="batch", use_dropout=True, dtype="bfloat16")
    jcfg, tcfg = configs(**fields)
    flats = flat_dicts(jax_params(jcfg, seed=3), tmp_path_factory.mktemp("w"))
    out = {}
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        state = torch_state(cfg, flats)
        _, metrics = TI.make_train_step(cfg, "cpu")(
            state, tiny_batch(13), torch.Generator().manual_seed(4))
        out[remat] = state, metrics
    return out


def test_bf16_step_keeps_f32_losses_weights_and_adam(bf16_steps):
    state, metrics = bf16_steps[False]
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
    for n in TRAINED:
        opt = getattr(state, f"opt_{n}")
        for p in getattr(state, n).parameters():
            assert p.dtype == p.grad.dtype == torch.float32
            assert torch.isfinite(p.grad).all()
            assert opt.state[p]["exp_avg"].dtype == torch.float32


def test_bf16_remat_step_is_bit_identical(bf16_steps):
    (s0, m0), (s1, m1) = bf16_steps[False], bf16_steps[True]
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for n in TRAINED:
        a, b = getattr(s0, n).state_dict(), getattr(s1, n).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), n
        for p, q in zip(getattr(s0, n).parameters(),
                        getattr(s1, n).parameters()):
            assert torch.equal(p.grad, q.grad)
