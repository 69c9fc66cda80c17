"""Port vs JAX: dynamic int8 inference (deepinpainting_torch/ops/quant.py,
Config.quant='int8').

Both packages quantise the same numbers the same way (per-tensor
activations, per-output-channel weights, round half to even, clip to
+-127), sum exactly in int32 and dequantise with the same two f32
multiplies, so on the same inputs the port's int8 convs equal JAX's bit for
bit, in f32 and in bf16.  The port's int32 sums equal its plain version (an
f64 convolution over the int8 values, exact) bit for bit; the cases cover
the padding of `torch._int_mm`'s operands (B*H*W <= 16 rows, Cout and K
not multiples of 8).

End to end, the port's f32 convs differ from XLA's in the last bits, which
can move an activation's q by one step; the int8 entry points are held to
a quarter of JAX's own int8-vs-f32 gap, measured in the same test on the
same weights and batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.ops import quant as JQ
from deepinpainting_torch.engine import export_model as EM
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import convs as TC
from deepinpainting_torch.ops import quant as TQ

from torch_port_helpers import (configs, flat_dicts, jax_params, nchw,
                                tiny_batch, torch_models, torch_state)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (kind, k, stride, padding, dilation, batch, Cin, Cout, H): the five
# geometries of the JAX package's tests/test_quant.py; three have
# B*Ho*Wo <= 16 output rows and two a Cout that is no multiple of 8
GEOMETRIES = [
    ("conv", 4, 2, 1, 1, 1, 32, 48, 8),     # halving: 16 output rows
    ("conv", 4, 2, 3, 2, 2, 32, 20, 6),     # dilated halving
    ("conv", 3, 1, 1, 1, 1, 16, 24, 4),     # same-size
    ("deconv", 4, 2, 1, 1, 1, 32, 16, 1),   # doubling from 1x1
    ("deconv", 3, 1, 1, 1, 2, 32, 20, 8),   # same-size
]


def _case(geometry, seed):
    kind, k, _, _, _, b, cin, cout, h = geometry
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (b, h, h, cin)).astype(np.float32)
    w = rng.normal(0, 0.02, (k, k, cin, cout)).astype(np.float32)  # HWIO
    bias = rng.normal(0, 0.01, (cout,)).astype(np.float32)
    # the port's layouts: Conv2d [Cout, Cin, kh, kw], ConvTranspose2d
    # [Cin, Cout, kh, kw]
    tw = w.transpose(3, 2, 0, 1) if kind == "conv" else w.transpose(2, 3, 0, 1)
    return x, w, bias, torch.from_numpy(np.ascontiguousarray(tw))


def test_quantize_activation_matches_jax():
    rng = np.random.default_rng(0)
    for shape, scale in (((2, 8, 8, 32), 1.0), ((1, 1, 1, 64), 3.0),
                         ((3, 5, 7, 16), 1e-3)):
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
        jq, js = JQ.quantize_activation(jnp.asarray(x))
        tq, ts = TQ.quantize_activation(nchw(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert ts.item() == float(js)
        np.testing.assert_array_equal(tq.numpy(),
                                      np.asarray(jq).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("layout", ["conv", "transposed"])
def test_quantize_weight_matches_jax(layout):
    """A Conv2d weight quantises per Cout over (Cin, kh, kw); a
    ConvTranspose2d weight per Cout too, which is its dimension 1, and
    JAX quantises the flipped kernel of the transposed conv."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.02, (4, 4, 24, 40)).astype(np.float32)   # HWIO
    w[:, :, :, 5] *= 50.0        # one channel with another range
    if layout == "conv":
        jq, js = JQ.quantize_weight(jnp.asarray(w))
        tq, ts = TQ.quantize_weight(torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
        want = np.asarray(jq).transpose(3, 2, 0, 1)
    else:
        jq, js = JQ.quantize_weight(jnp.flip(jnp.asarray(w), axis=(0, 1)))
        tq, ts = TQ.quantize_weight(torch.from_numpy(np.ascontiguousarray(
            w.transpose(2, 3, 0, 1))), transposed=True)
        want = np.flip(np.asarray(jq), axis=(0, 1)).transpose(2, 3, 0, 1)
    assert ts.shape == (40,) and tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: f"{g[0]}_k{g[1]}s{g[2]}p{g[3]}d{g[4]}")
def test_int8_conv_matches_jax_bit_for_bit(geometry, dtype):
    kind, _, s, p, d = geometry[:5]
    jdt, tdt = DTYPES[dtype]
    x, w, bias, tw = _case(geometry, seed=2)
    jx = jnp.asarray(x).astype(jdt)
    jw = jnp.asarray(w).astype(jdt)
    tx = nchw(x).to(tdt)
    tb = torch.from_numpy(bias)
    if kind == "conv":
        want = JQ.conv2d_int8(jx, jw, jnp.asarray(bias), s, p, d)
        got = TQ.conv2d_int8(tx, tw.to(tdt), tb, s, p, d)
    else:
        want = JQ.conv_transpose2d_int8(jx, jw, jnp.asarray(bias), s, p)
        got = TQ.conv_transpose2d_int8(tx, tw.to(tdt), tb, s, p)
    assert got.dtype == tdt
    # XLA's x / scale rounds as torch's does: not one q value differs
    jq, _ = JQ.quantize_activation(jx)
    tq, _ = TQ.quantize_activation(tx)
    assert int((tq.numpy() != np.asarray(jq).transpose(0, 3, 1, 2)).sum()) == 0
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("geometry", GEOMETRIES + [
    ("conv", 3, 1, 1, 1, 1, 3, 5, 4),       # K = 27, Cout = 5: padded
    ("conv", 1, 1, 0, 1, 20, 16, 8, 1),     # M = 20 > 16 with no padding
], ids=lambda g: f"{g[0]}_k{g[1]}s{g[2]}p{g[3]}d{g[4]}_b{g[5]}c{g[6]}")
def test_int32_sums_equal_the_plain_version(geometry):
    kind, _, s, p, d = geometry[:5]
    rng = np.random.default_rng(3)
    x, _, _, tw = _case(geometry, seed=3)
    xq = torch.from_numpy(rng.integers(-127, 128, nchw(x).shape,
                                       dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, tw.shape, dtype=np.int8))
    if kind == "conv":
        fast = lambda a, w: TQ.conv2d_int32(a, w, s, p, d)
        plain = lambda a, w: TQ.conv2d_int32_reference(a, w, s, p, d)
    else:
        fast = lambda a, w: TQ.conv_transpose2d_int32(a, w, s, p)
        plain = lambda a, w: TQ.conv_transpose2d_int32_reference(a, w, s, p)
    # random values, then the extremes: every product -127 * 127
    for a, w in ((xq, wq), (torch.full_like(xq, 127),
                            torch.full_like(wq, -127))):
        got, want = fast(a, w), plain(a, w)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)


def test_narrow_convs_stay_in_the_activation_dtype():
    """Under int8 a conv with Cin or Cout below 16 is the direct conv, bit
    for bit; an eligible one takes the int8 path."""
    torch.manual_seed(0)
    narrow = TC.Conv2d(3, 32, 4, 2, 1)
    wide = TC.Conv2d(32, 16, 3, 1, 1)
    head = TC.ConvTranspose2d(32, 3, 4, 2, 1)
    x3, x32 = torch.randn(1, 3, 16, 16), torch.randn(1, 32, 8, 8)
    with torch.no_grad():
        off = [narrow(x3), wide(x32), head(x32)]
        with TC.use_modes(TC.ConvModes(int8=True)):
            on = [narrow(x3), wide(x32), head(x32)]
    assert torch.equal(on[0], off[0]) and torch.equal(on[2], off[2])
    assert torch.equal(on[1], TQ.conv2d_int8(x32, wide.weight, wide.bias,
                                             1, 1, 1))
    assert not torch.equal(on[1], off[1])
    assert not TQ.eligible(3, 32) and TQ.eligible(16, 16)


def test_modes_come_back_after_an_exception():
    with pytest.raises(RuntimeError):
        with TC.conv_modes(configs(quant="int8")[1]):
            assert TC.current_modes().int8
            raise RuntimeError
    assert TC.current_modes() == TC.ConvModes()


@pytest.fixture(scope="module")
def end_to_end(tmp_path_factory):
    """JAX f32, JAX int8 and the port's int8 results of the inference
    function, the eval step and the coarse function, on bridged weights and
    a small-hole batch (7 and 5 masked attention positions)."""
    jcfg, tcfg = configs(batch_size=2, mask_type="random", is_train=False)
    params = jax_params(jcfg, seed=3)
    state = torch_state(tcfg, flat_dicts(params,
                                         tmp_path_factory.mktemp("w")))
    batch = tiny_batch(21)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for quant in ("none", "int8"):
        jc = jcfg.replace(quant=quant)
        inf = jax.jit(JI.make_inference_fn(jc))(
            params["G"], params["P"], params["vgg"], jb["image"], jb["mask"],
            jb["ref"])
        ev = jax.jit(JI.make_eval_step(jc))(
            JST.create_train_state(jcfg, params), jb)
        co = jax.jit(JI.make_coarse_fn(jc))(params["P"], jb["image"],
                                            jb["mask"])
        out[quant] = {"inference": (inf[0], inf[1]),
                      "eval": (ev["fake_B"], ev["fake_P"]),
                      "coarse": (co[0], co[1])}
    tc = tcfg.replace(quant="int8")
    G, P, vgg = state.G.eval(), state.P.eval(), state.vgg
    inf = TI.make_inference_fn(tc, "cpu")(G, P, vgg, batch["image"],
                                          batch["mask"], batch["ref"])
    ev = TI.make_eval_step(tc, "cpu")(state, batch)
    co = TI.make_coarse_fn(tc, "cpu")(P, batch["image"], batch["mask"])
    out["port"] = {"inference": inf, "eval": (ev["fake_B"], ev["fake_P"]),
                   "coarse": co}
    return out


@pytest.mark.parametrize("entry", ["inference", "eval", "coarse"])
def test_int8_entry_points_match_jax_int8(end_to_end, entry):
    for i in range(2):
        f32 = np.asarray(end_to_end["none"][entry][i], np.float64)
        want = np.asarray(end_to_end["int8"][entry][i], np.float64)
        got = end_to_end["port"][entry][i].numpy().astype(np.float64)
        assert got.shape == want.shape and np.isfinite(got).all()
        own = np.abs(want - f32).mean()
        assert own > 0, "the int8 path must differ from the f32 one"
        assert np.abs(got - want).mean() <= 0.25 * own, (
            np.abs(got - want).mean(), own)


def test_training_refuses_int8_and_unknown_modes_are_refused():
    _, tcfg = configs(quant="int8")
    gen = torch.Generator().manual_seed(0)
    for make in (lambda: TI.make_train_step(tcfg, "cpu"),
                 lambda: TI.create_state(tcfg, gen, "cpu")):
        with pytest.raises(NotImplementedError, match="quant"):
            make()
    _, int4 = configs(quant="int4")
    for make in (lambda: TI.build_models(int4),
                 lambda: TI.make_inference_fn(int4, "cpu"),
                 lambda: TI.make_eval_step(int4, "cpu"),
                 lambda: TI.make_coarse_fn(int4, "cpu")):
        with pytest.raises(NotImplementedError, match="int4"):
            make()


def test_int8_export_equals_live_int8_serving(tmp_path):
    """An int8 config is traced into the artifact: its graph multiplies
    with aten._int_mm, config.json records quant='int8', and the loaded
    call equals the live int8 serving function bit for bit."""
    jcfg, tcfg = configs(mask_type="random", is_train=False, quant="int8")
    models = torch_models(tcfg, flat_dicts(jax_params(jcfg, seed=21),
                                           tmp_path))
    out = str(tmp_path / "artifact")
    EM.export_serving(tcfg, models, out, device="cpu")
    loaded = EM.load_serving(out, "cpu")
    assert loaded.cfg.quant == "int8" and loaded.batch == "symbolic"
    assert "aten._int_mm.default" in EM.graph_ops(
        loaded.exported["symbolic"])
    live = TI.make_serving_fn(tcfg, "cpu")
    for b in (1, 3):
        batch = tiny_batch(40 + b, b)
        args = (batch["image"], batch["mask"], batch["ref"])
        assert torch.equal(loaded.call(loaded.G, loaded.P, loaded.vgg, *args),
                           live(*models, *args))


def test_cli_evaluate_with_quant_int8(tmp_path):
    """`_cli evaluate --quant int8` restores a training checkpoint (whose
    state int8 cannot build) and evaluates it on the int8 path: its
    figures are evaluate()'s with the int8 config, and not the f32 ones."""
    from PIL import Image
    from deepinpainting_torch import _cli
    from deepinpainting_torch.data.dataset import SelfRefDataset
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.engine.evaluator import evaluate
    rng = np.random.default_rng(0)
    img, mask = tmp_path / "img", tmp_path / "mask"
    img.mkdir()
    mask.mkdir()
    for i, m in enumerate(tiny_batch(0, b=2)["mask"]):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(img / f"x{i}.png")
        Image.fromarray(np.repeat(m[..., None] * 255, 3, -1)
                        ).save(mask / f"m{i}.png")
    _, tcfg = configs(batch_size=2, mask_type="random", data_workers=0,
                      checkpoints_dir=str(tmp_path / "ck"), name="run")
    state = TI.create_state(tcfg, torch.Generator().manual_seed(1), "cpu")
    CheckpointManager(tcfg).save(1, state)
    args = ["--dataroot", str(img), "--maskroot", str(mask),
            "--checkpoints_dir", tcfg.checkpoints_dir, "--name", "run",
            "--which_epoch", "1", "--device", "cpu"]
    got = _cli.evaluate(args + ["--quant", "int8"])
    f32 = _cli.evaluate(args)
    ds = SelfRefDataset(str(img), str(mask), 64)
    want = evaluate(tcfg.replace(quant="int8", is_train=False), state, ds,
                    device="cpu", verbose=False)
    assert got == want and got["images"] == 2
    assert got["psnr"] != f32["psnr"]
