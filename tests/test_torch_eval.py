"""Port vs JAX: the eval step, the coarse stage and the evaluator.

Both packages run the tiny 64 px config from the same bridged weights
(numpy seed) on the same uint8 batches; the JAX functions run jitted on
the CPU, with the Pallas scan in interpret mode (attention_impl='pallas',
the default).  Tolerances, and why:
  * fake_B, fake_P and the coarse stage: 1e-4 absolute, as the two-stage
    forward's own parity tests (f32 sums in another order through two
    U-Nets and a short attention chain);
  * loss_ipsr and loss_valid: 1e-4 relative;
  * PSNR 1e-3 dB and SSIM 1e-4: what a 1e-4 difference in fake_B moves
    them by at most, with room;
  * real_A, real_Ref and real_B: within one f32 ulp of values in [-1, 1]
    (the uint8 normalisation x/127.5 - 1, which XLA compiles into an
    arithmetic that differs in the last bit on 3/4 of the pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deepinpainting_tpu.data.dataset import SelfRefDataset as JSelfRef
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.engine.evaluator import evaluate as jevaluate
from deepinpainting_torch.data.dataset import SelfRefDataset
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine.evaluator import evaluate
from deepinpainting_torch.ops import attention as TA

from torch_port_helpers import (configs, flat_dicts, jax_params, tiny_batch,
                                torch_state)

FIELDS = dict(batch_size=2, use_dropout=False, mask_type="random",
              data_workers=0)
VISUALS = ("real_A", "real_Ref", "fake_B", "fake_P", "real_B")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = configs(**FIELDS)
    params = jax_params(jcfg, seed=3)
    flats = flat_dicts(params, tmp_path_factory.mktemp("w"))
    return jcfg, tcfg, params, torch_state(tcfg, flats)


@pytest.fixture(scope="module")
def stepped(setup):
    """One eval step on each side, with the port's recurrences counted."""
    jcfg, tcfg, params, tstate = setup
    batch = tiny_batch(21)
    jout = jax.jit(JI.make_eval_step(jcfg))(
        JST.create_train_state(jcfg, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    calls = {"scan": 0, "kbar": 0}
    scan, kbar = TA.scan_stream, TA.kbar_build

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    TA.scan_stream, TA.kbar_build = count("scan", scan), count("kbar", kbar)
    try:
        tout = TI.make_eval_step(tcfg, "cpu")(tstate, batch)
    finally:
        TA.scan_stream, TA.kbar_build = scan, kbar
    return jout, tout, calls, tstate


@pytest.mark.parametrize("key", ["fake_B", "fake_P"])
def test_eval_images_match(stepped, key):
    jout, tout, _, _ = stepped
    assert tuple(tout[key].shape) == (2, 64, 64, 3)
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("key", ["loss_ipsr", "loss_valid"])
def test_eval_losses_match(stepped, key):
    jout, tout, _, _ = stepped
    assert tout[key].dim() == 0
    np.testing.assert_allclose(float(tout[key]), float(jout[key]), rtol=1e-4)


@pytest.mark.parametrize("key,atol", [("psnr", 1e-3), ("ssim", 1e-4)])
def test_eval_metrics_match(stepped, key, atol):
    jout, tout, _, _ = stepped
    assert tuple(tout[key].shape) == (2,)
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("key", VISUALS)
def test_eval_visuals_match(stepped, key):
    jout, tout, _, _ = stepped
    got, want = tout["visuals"][key].numpy(), np.asarray(jout["visuals"][key])
    assert got.shape == want.shape == (2, 64, 64, 3)
    if key in ("fake_B", "fake_P"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -23)


def test_eval_step_scans_once_builds_no_kbar_and_keeps_modes(stepped):
    _, tout, calls, tstate = stepped
    assert calls == {"scan": 1, "kbar": 0}
    # real_A is the zero-holed input the reference's netG sees (`known`)
    vis = {k: v.numpy() for k, v in tout["visuals"].items()}
    hole = tiny_batch(21)["mask"][..., None].astype(np.float32)
    np.testing.assert_array_equal(vis["real_A"], vis["real_B"] * (1 - hole))
    # the state came in training mode and goes back to it
    assert tstate.G.training and tstate.P.training
    assert not tout["fake_B"].requires_grad


def test_coarse_matches_jax(setup):
    jcfg, tcfg, params, tstate = setup
    batch = tiny_batch(22)
    jfp, jcomp = jax.jit(JI.make_coarse_fn(jcfg))(
        params["P"], jnp.asarray(batch["image"]), jnp.asarray(batch["mask"]))
    tstate.P.eval()
    try:
        tfp, tcomp = TI.make_coarse_fn(tcfg, "cpu")(
            tstate.P, batch["image"], batch["mask"])
    finally:
        tstate.P.train()
    np.testing.assert_allclose(tfp.numpy(), np.asarray(jfp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tcomp.numpy(), np.asarray(jcomp), rtol=0,
                               atol=1e-4)
    # outside the hole the composite is the image itself
    keep = batch["mask"] == 0
    np.testing.assert_array_equal(
        tcomp.numpy()[keep], batch["image"][keep].astype(np.float32) / 127.5
        - 1.0)


def test_evaluate_series_matches_jax(setup, tmp_path):
    """5 images at B=2: the tail batch is padded and exactly 5 counted."""
    jcfg, tcfg, params, tstate = setup
    rng = np.random.default_rng(5)
    img, mask = tmp_path / "img", tmp_path / "mask"
    img.mkdir()
    mask.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(img / f"x{i}.png")
    for i, m in enumerate(tiny_batch(0, b=2)["mask"]):
        Image.fromarray(np.repeat(m[..., None] * 255, 3, -1)
                        ).save(mask / f"m{i}.png")
    got = evaluate(tcfg, tstate, SelfRefDataset(str(img), str(mask), 64),
                   device="cpu", verbose=False, return_per_image=True,
                   save_dir=str(tmp_path / "grids"))
    want = jevaluate(jcfg, JST.create_train_state(jcfg, params),
                     JSelfRef(str(img), str(mask), 64), verbose=False,
                     return_per_image=True)
    assert got["images"] == want["images"] == 5
    assert len(got["psnr_per_image"]) == 5
    np.testing.assert_allclose(got["psnr_per_image"], want["psnr_per_image"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ssim_per_image"], want["ssim_per_image"],
                               rtol=0, atol=1e-4)
    assert got["psnr"] == pytest.approx(np.mean(got["psnr_per_image"]))
    assert sorted(p.name for p in (tmp_path / "grids").iterdir()) == [
        f"Eval_({i}).jpg" for i in range(1, 6)]
    # max_images stops early, counting whole images only
    assert evaluate(tcfg, tstate, SelfRefDataset(str(img), str(mask), 64),
                    max_images=3, device="cpu", verbose=False)["images"] == 3
