"""The conv modes under spatial partitioning on 2 and 4 gloo ranks on the
CPU, each rank holding its slab of rows (H) of the same inputs, against
the same computation on the whole tensor in one process:

  * int8: each conv and transposed-conv geometry of the two U-Nets (netP's
    k4 s2 p1 and its k4 s2 p1 deconv; netG's dilated k4 s2 p3 d2, k3 s1
    p1 and k3 s1 p1 deconv), Cin = Cout = 16: the slabs' int32 sums,
    concatenated in rank order, and the activation scale are the whole
    tensor's bit for bit (integer sums are exact, and the scale is the
    maximum over every slab);
  * the pack rewrites at H = 256, where pack_out fires on the whole image
    but not on a slab's own height: the tap stack and space-to-depth
    (Cin 4), hpack2 of a k3 s1 conv and of a k3 s1 deconv, dpack4 (Cin 32),
    forward and backward of sum(y * w) within 1e-6 (on multiples of 1/8,
    whose sums are exact: the rewrites' indexing alone), each slab calling
    exactly the rewrites the whole image calls (the gates read the whole
    image's height); at H = 64 hpack2 does not fire and dpack4 does (2H =
    128), on the whole image and on every slab alike; at H = 132 a slab of
    33 rows (4 ranks) cannot pair hpack2's rows and takes the direct conv,
    whose sums are the same;
  * make_sp_inference_fn at the tiny config (bridged weights, seed 3)
    with pack_small_cin and pack_out (gates lowered so that hpack2 and
    dpack4 fire at 64 px, in both packages) within 2e-4 of the port's
    one-process packed forward and of the JAX package's
    make_sp_inference_fn with the same modes on the 8 virtual CPU
    devices; with int8 against the port's one-process int8 forward: mean
    |d| <= 0.05 on [-1, 1], JAX's int8 limit (tests/test_quant.py).  The
    slabs' f32 sums (the convs too narrow for int8, the norms) land an
    ulp away, and an int8 input on a rounding boundary would then move by
    a level; measured here at 2 and 4 ranks: fake_B mean |d| 2.6e-7 to
    3.2e-7, max 2.6e-6 (no input crossed a boundary), fake_P max 2.7e-7;
  * SP int8 against the JAX package's one-device int8 forward of the
    whole image, by tests/test_torch_quant.py's rule (mean |d| <= 0.25 x
    JAX's own int8-vs-f32 gap, 0.26 and 0.17 here), at the image or at
    the image one ulp (2^-23) larger or smaller: an int8 input on a
    rounding tie in one package lands an ulp away in the other and moves
    the whole output (4 ranks, the first request one ulp smaller: 0.20
    from JAX's, against 3.6e-7 at the image); measured 3.5e-7 to 5.8e-5.
    Each slab scaled by its own maximum (the all-reduce taken out in the
    ranks) fails the rule at all three: 0.16 to 0.23;
  * the 1 x 2 grid's train step with both pack modes (gates lowered) by
    tests/test_torch_sp_step.py's rules against the port's one-process
    packed step.

The JAX package's own make_sp_inference_fn fails with quant='int8' on
the CPU (XLA's verifier after spmd-partitioning; JAX_SP_INT8_FAILS), so
the port's SP int8 is held against the port's one-process int8, which
tests/test_torch_quant.py holds against JAX's conv by conv, and against
JAX's one-device int8 on the whole image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from deepinpainting_tpu import parallel as PP
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.ops import convs as JC
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import convs, quant

from torch_port_helpers import (TRAINED, configs, flat_dicts, jax_params,
                                state_grads, tiny_batch, torch_models,
                                torch_state)

WORLDS = (2, 4)
TOL = dict(rtol=1e-6, atol=1e-6)
SP_TOL = dict(rtol=2e-4, atol=2e-4)
INT8_GAP = 0.05
JAX_GAP_SHARE = 0.25    # of JAX's own int8-vs-f32 gap (test_torch_quant.py)
ULP = 2.0 ** -23        # the images' relative nudges, one ulp of 1.0
S = 64
LOWERED = {"_PACK_OUT_MIN_HW": 16, "_PACK_OUT_MIN_CIN": 4}
# the error text of the JAX package's make_sp_inference_fn with int8
JAX_SP_INT8_FAILS = "SameElementType"
INT8_LAYERS = {
    "conv_k4s2p1": lambda: convs.Conv2d(16, 16, 4, 2, 1),
    "conv_k4s2p3d2": lambda: convs.Conv2d(16, 16, 4, 2, 3, dilation=2),
    "conv_k3s1p1": lambda: convs.Conv2d(16, 16, 3, 1, 1),
    "convT_k3s1p1": lambda: convs.ConvTranspose2d(16, 16, 3, 1, 1),
    "convT_k4s2p1": lambda: convs.ConvTranspose2d(16, 16, 4, 2, 1)}
# case: (layer, input height); the rewrites the whole image calls
PACK_CASES = {
    "tap_stack": (lambda: convs.Conv2d(4, 8, 3, 1, 1), 256),
    "space_to_depth": (lambda: convs.Conv2d(4, 8, 4, 2, 1), 256),
    "hpack2": (lambda: convs.Conv2d(32, 8, 3, 1, 1), 256),
    "hpack2_deconv": (lambda: convs.ConvTranspose2d(32, 8, 3, 1, 1), 256),
    "dpack4": (lambda: convs.ConvTranspose2d(32, 16, 4, 2, 1), 256),
    "hpack2_h64": (lambda: convs.Conv2d(32, 8, 3, 1, 1), 64),
    "dpack4_h64": (lambda: convs.ConvTranspose2d(32, 16, 4, 2, 1), 64),
    "hpack2_h132": (lambda: convs.Conv2d(32, 8, 3, 1, 1), 132)}
WANT_CALLS = {"tap_stack": "_conv2d_tap_stack",
              "space_to_depth": "_conv2d_space_to_depth",
              "hpack2": "_conv2d_hpack2", "hpack2_deconv": "_conv2d_hpack2",
              "dpack4": "_deconv_dpack4", "hpack2_h64": None,
              "dpack4_h64": "_deconv_dpack4", "hpack2_h132": "_conv2d_hpack2"}


def _dyadic(shape, g):
    """Multiples of 1/8 in [-1/2, 1/2]: the pack cases' sums, forward and
    backward, are then exact in f32 in any order, so the slabs hold the
    whole image's rewrite to its indexing alone."""
    return torch.randint(-4, 5, shape, generator=g).float() / 8


def _filled(layer, g):
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(_dyadic(p.shape, g))
    return layer


def _spies(mp):
    """Count the rewrites and record int8's sums in this process, undone
    with `mp`."""
    calls = {n: 0 for n in W.REWRITES}
    for n in W.REWRITES:
        def wrapped(*a, _n=n, _f=getattr(convs, n)):
            calls[_n] += 1
            return _f(*a)
        mp.setattr(convs, n, wrapped)
    sums = []
    dequantize = quant._dequantize

    def recorded(acc, sx, *a):
        sums.append((acc.clone(), sx.clone()))
        return dequantize(acc, sx, *a)
    mp.setattr(quant, "_dequantize", recorded)
    return calls, sums


def _request(b, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, S, S), np.uint8)
    mask[0, 16:48, 20:44] = 1
    if b > 1:
        mask[1, 40:52, 8:30] = 1
    return {"image": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8),
            "mask": mask,
            "ref": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)}


def _nudged(request, e):
    """The request with its image (1 + e) times as large, as floats."""
    x = request["image"].astype(np.float32) / 127.5 - 1.0
    return dict(request, image=x * np.float32(1.0 + e))


def _jax_one_device(jcfg, params, requests):
    fn = jax.jit(JI.make_inference_fn(jcfg))
    return [tuple(np.asarray(o, np.float64) for o in fn(
        params["G"], params["P"], params["vgg"],
        *(jnp.asarray(r[k]) for k in ("image", "mask", "ref"))))
        for r in requests]


def _jax_sp(jcfg, params, requests):
    fn = PP.make_sp_inference_fn(jcfg, PP.make_sp_mesh())
    outs = []
    for r in requests:
        placed = PP.place_spatial({k: jnp.asarray(v) for k, v in r.items()},
                                  PP.make_sp_mesh())
        outs.append(tuple(np.asarray(o) for o in fn(
            params["G"], params["P"], params["vgg"], placed["image"],
            placed["mask"], placed["ref"])))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    int8 = {name: (_filled(make(), g), torch.randn(2, 16, 16, 10,
                                                   generator=g))
            for name, make in INT8_LAYERS.items()}
    pack = {}
    for name, (make, h) in PACK_CASES.items():
        layer = _filled(make(), g)
        x = _dyadic((2, layer.in_channels, h, 6), g)
        with torch.no_grad():
            wy = _dyadic(layer(x).shape, g)
        pack[name] = (layer, x, wy)
    jcfgs = {"pack": configs(mask_type="random", pack_small_cin=True,
                             pack_out=True),
             "int8": configs(mask_type="random", quant="int8")}
    params = jax_params(jcfgs["int8"][0], seed=3)
    models = torch_models(jcfgs["int8"][1], flat_dicts(
        params, tmp_path_factory.mktemp("w")))
    requests = [_request(1, 11), _request(2, 12)]
    want = {"int8": {}, "pack": {}, "infer": {}}
    with pytest.MonkeyPatch.context() as mp:
        calls, sums = _spies(mp)
        for name, (layer, x) in int8.items():
            sums.clear()
            with torch.no_grad(), convs.use_modes(convs.ConvModes(int8=True)):
                want["int8"][name] = (layer(x), *sums[0])
        for name, (layer, x, wy) in pack.items():
            layer = layer.__class__.__new__(layer.__class__)
            layer.__dict__.update(pack[name][0].__dict__)
            for k in calls:
                calls[k] = 0
            layer.zero_grad()
            xs = x.clone().requires_grad_(True)
            with convs.use_modes(convs.ConvModes(pack_small_cin=True,
                                                 pack_out=True)):
                y = layer(xs)
            (y * wy).sum().backward()
            want["pack"][name] = (y.detach(), xs.grad,
                                  {k: p.grad.clone() for k, p in
                                   layer.named_parameters()}, dict(calls))
            layer.zero_grad()
        for name, (_, tcfg) in jcfgs.items():
            for k in calls:
                calls[k] = 0
            sums.clear()
            with W.lowered(LOWERED if name == "pack" else {}):
                want["infer"][name] = (
                    [TI.make_inference_fn(tcfg, "cpu")(
                        *models, r["image"], r["mask"], r["ref"])
                     for r in requests],
                    dict(calls), [s for _, s in sums])
        for k, v in LOWERED.items():
            mp.setattr(JC, k, v)
        jax_pack = _jax_sp(jcfgs["pack"][0], params, requests)
    jax_one = {q: _jax_one_device(configs(mask_type="random", quant=q)[0],
                                  params, requests)
               for q in ("none", "int8")}
    ranks = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"knobs{world}")
        torch.save({"int8": int8, "pack": pack,
                    "cfgs": {k: v[1] for k, v in jcfgs.items()},
                    "lowered": LOWERED,
                    "models": [net.state_dict() for net in models],
                    "requests": requests,
                    "int8_variants": [requests] + [
                        [_nudged(r, e) for r in requests]
                        for e in (ULP, -ULP)]}, tmp / "inputs.pt")
        W.run_ranks(W.sp_knobs, world, tmp)
        ranks[world] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                        for r in range(world)]
    return want, jax_pack, ranks, params, jcfgs, requests, jax_one


def _rows_of(name, acc, h):
    """A transposed conv's sums on a halo'd slab, cut to the slab's own
    output rows (ops/convs.py::_slab_conv_transpose2d); a conv's as they
    are."""
    if not name.startswith("convT"):
        return acc
    layer = INT8_LAYERS[name]()
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    return acc.narrow(2, (k - 1 - p) // s * s, h * s)


@pytest.mark.parametrize("name", INT8_LAYERS)
@pytest.mark.parametrize("world", WORLDS)
def test_int8_sums_on_slabs_are_the_whole_tensors(runs, world, name):
    want, _, ranks, *_ = runs
    y, acc, sx = want["int8"][name]
    got = [r["int8"][name] for r in ranks[world]]
    h = 16 // world
    assert torch.equal(torch.cat([_rows_of(name, g[1], h) for g in got], 2),
                       acc)
    assert all(torch.equal(g[2], sx) for g in got)
    assert torch.equal(torch.cat([g[0] for g in got], 2), y)


@pytest.mark.parametrize("name", PACK_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_pack_rewrites_on_slabs_match_the_whole_image(runs, world, name):
    want, _, ranks, *_ = runs
    wy, wgrad, wparams, wcalls = want["pack"][name]
    got = [r["pack"][name] for r in ranks[world]]
    rewrite = WANT_CALLS[name]
    assert {k for k, c in wcalls.items() if c} == (
        {rewrite} if rewrite else set())
    # hpack2 pairs output rows: 33-row slabs take the direct conv
    slab_packs = not (name == "hpack2_h132" and world == 4)
    for g in got:
        assert g[3] == (wcalls if slab_packs else
                        {k: 0 for k in wcalls}), g[3]
    np.testing.assert_allclose(torch.cat([g[0] for g in got], 2), wy, **TOL)
    np.testing.assert_allclose(torch.cat([g[1] for g in got], 2), wgrad,
                               **TOL)
    for k, v in wparams.items():
        np.testing.assert_allclose(sum(g[2][k] for g in got), v, rtol=1e-6,
                                   atol=1e-6 * float(v.abs().max()),
                                   err_msg=k)


def _whole(outs):
    """fake_B and fake_P of each request, the slabs concatenated (NHWC:
    rows are axis 1)."""
    return [tuple(torch.cat([o[ri][k] for o in outs], 1).numpy()
                  for k in (0, 1)) for ri in range(len(outs[0]))]


@pytest.mark.parametrize("world", WORLDS)
def test_sp_packed_inference_matches_one_process_and_jax(runs, world):
    want, jax_pack, ranks, *_ = runs
    outs, wcalls, _ = want["infer"]["pack"]
    assert all(wcalls.values()), wcalls     # every rewrite fires
    got = _whole([r["infer"]["pack"][0] for r in ranks[world]])
    for r in ranks[world]:
        assert set(r["infer"]["pack"][1]) == set(wcalls)
        assert all(r["infer"]["pack"][1].values())
    for (gb, gp), (wb, wp), (jb, jp) in zip(got, outs, jax_pack):
        np.testing.assert_allclose(gp, wp.numpy(), **SP_TOL)
        np.testing.assert_allclose(gb, wb.numpy(), **SP_TOL)
        np.testing.assert_allclose(gp, jp, **SP_TOL)
        np.testing.assert_allclose(gb, jb, **SP_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_int8_inference_matches_one_process_int8(runs, world):
    want, _, ranks, *_ = runs
    outs, _, scales = want["infer"]["int8"]
    got = _whole([r["infer"]["int8"][0] for r in ranks[world]])
    for r in ranks[world]:
        # the same int8 convs on every rank, each scale a whole tensor's
        assert len(r["infer"]["int8"][2]) == len(scales) > 0
    for (gb, gp), (wb, wp) in zip(got, outs):
        assert np.isfinite(gb).all()
        assert np.abs(gb - wb.numpy()).mean() <= INT8_GAP
        np.testing.assert_allclose(gp, wp.numpy(), **SP_TOL)


def test_jax_sp_int8_fails_on_the_cpu(runs):
    """A fault of the reference, pinned: XLA's verifier refuses the int8
    convs of the JAX package's SP program after spmd-partitioning.  If a
    later JAX runs it, hold the port's SP int8 against it here and drop
    JAX_SP_INT8_FAILS."""
    _, _, _, params, jcfgs, requests, _ = runs
    try:
        _jax_sp(jcfgs["int8"][0], params, requests[:1])
    except Exception as e:             # XLA's error type varies by version
        assert JAX_SP_INT8_FAILS in str(e), str(e)[:2000]
        return
    pytest.fail("the JAX package's make_sp_inference_fn ran with "
                "quant='int8': hold the port's SP int8 inference against it "
                "and drop JAX_SP_INT8_FAILS")


# ---- the 1 x 2 packed train step ------------------------------------------

@pytest.fixture(scope="module")
def step(tmp_path_factory):
    _, tcfg = configs(batch_size=4, use_dropout=False, mask_type="random",
                      pack_small_cin=True, pack_out=True)
    jcfg, _ = configs()
    tmp = tmp_path_factory.mktemp("step")
    flats = flat_dicts(jax_params(jcfg, seed=9), tmp)
    batch = tiny_batch(104, 4)
    ranks = tmp / "ranks"
    ranks.mkdir()
    torch.save({"state": torch_state(tcfg, flats).state_dict(),
                "batch": batch}, ranks / "inputs.pt")
    W.run_ranks(W.sp_step_lowered, 2, ranks, tcfg, 1, LOWERED)
    got = [torch.load(ranks / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    with W.lowered(LOWERED):
        state = torch_state(tcfg, flats)
        _, metrics = TI.make_train_step(tcfg, "cpu")(state, batch)
        nudged = torch_state(tcfg, flats)
        with torch.no_grad():
            for net in (nudged.G, nudged.P):
                next(net.parameters()).mul_(1 + 1e-7)
        TI.make_train_step(tcfg, "cpu")(nudged, batch)
    grads = {n: state_grads(state, n) for n in TRAINED}
    envelope = {n: {k: float((g - grads[n][k]).abs().max())
                    for k, g in state_grads(nudged, n).items()}
                for n in ("G", "P")}
    return tcfg, got, {k: float(v) for k, v in metrics.items()}, grads, \
        {n: getattr(state, n).state_dict() for n in TRAINED}, envelope


def test_packed_step_on_the_grid_matches_one_process(step):
    cfg, ranks, metrics, grads, after, envelope = step
    for r, res in enumerate(ranks):
        assert res["grid"] == (1, 2, 0, r)
        assert res["metrics"] == ranks[0]["metrics"]
    got = ranks[0]["metrics"]
    for k in ("G_L1", "D"):
        np.testing.assert_allclose(got[k], metrics[k], rtol=5e-4, err_msg=k)
    np.testing.assert_allclose(got["G_GAN"], metrics["G_GAN"], rtol=0.2)
    keys = [k for k in after["G"] if "running_" not in k
            and "num_batches" not in k]
    a = torch.cat([ranks[0]["after"]["G"][k].reshape(-1) for k in keys])
    b = torch.cat([after["G"][k].reshape(-1) for k in keys])
    assert float((a - b).abs().max()) <= 2.2 * cfg.lr
    agree = np.isclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5).mean()
    assert agree > 0.90, f"only {agree:.4%} of G's parameters agree"
    for net in TRAINED:
        for k, w in grads[net].items():
            atol = 1e-6 + 1e-4 * float(w.abs().max())
            if net in envelope:
                atol += 8.0 * envelope[net][k]
            np.testing.assert_allclose(
                ranks[0]["grads"][net][k].numpy(), w.numpy(), rtol=0,
                atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("world", WORLDS)
def test_sp_int8_inference_matches_jax_one_device_int8(runs, world):
    """SP int8 fake_B at the images or one ulp away against the JAX
    package's one-device int8 forward of the whole image, by
    test_torch_quant.py's rule; each slab scaled by its own maximum fails
    it at all three."""
    *_, ranks, _, _, requests, jax_one = runs
    var = {m: [_whole(list(v)) for v in zip(*(r["int8_variants"][m]
                                                for r in ranks[world]))]
           for m in ("global", "slab")}
    for i in range(len(requests)):
        want, f32 = jax_one["int8"][i][0], jax_one["none"][i][0]
        own = np.abs(want - f32).mean()
        assert own > 0, "JAX's int8 path must differ from its f32 one"
        d = {m: [np.abs(v[i][0] - want).mean() for v in var[m]]
             for m in var}
        assert all(np.isfinite(v[i][0]).all() for v in var["global"])
        assert min(d["global"]) <= JAX_GAP_SHARE * own, (d, own)
        assert min(d["slab"]) > JAX_GAP_SHARE * own, (d, own)
