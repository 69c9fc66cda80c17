"""The port's epoch trainer: a whole fit on the CPU, resume, the NaN guard,
the refusals, and one epoch against the JAX package's Trainer.

The parity epoch starts both trainers from the same bridged weights and
fresh Adam state on the same data directories and seed, so they see the
same batches (tests/test_torch_data.py holds that bit for bit); it uses
faithful_backward_truncation=False, whose backward has no jump.  Per-step
G_L1, G_GAN, D and F within 1e-3 relative: the JAX Trainer runs its
data-parallel step over two CPU devices, and the second step starts from
the first step's Adam update on both sides.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from deepinpainting_tpu.data import InpaintDataset as JInpaintDataset
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.engine.trainer import Trainer as JTrainer
from deepinpainting_tpu.parallel import mesh as pmesh
from deepinpainting_torch.data import InpaintDataset
from deepinpainting_torch.engine.schedules import lr_for_epoch
from deepinpainting_torch.engine.state import current_learning_rate
from deepinpainting_torch.engine.trainer import Trainer
from deepinpainting_torch.parallel import mesh

from torch_port_helpers import (configs, flat_dicts, jax_params, tiny_batch,
                                torch_state)

S = 64
FIELDS = dict(batch_size=2, use_dropout=False, mask_type="random",
              data_workers=0, seed=3)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """4 training images and refs, 2 validation images, and masks with the
    small holes of tiny_batch (short attention chains)."""
    root = tmp_path_factory.mktemp("tdata")
    rng = np.random.default_rng(0)
    out = {}
    for name, n in (("img", 4), ("ref", 4), ("val", 2)):
        d = root / name
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (S, S, 3), dtype=np.uint8)
                            ).save(d / f"x{i}.png")
        out[name] = str(d)
    d = root / "mask"
    d.mkdir()
    for i, m in enumerate(tiny_batch(0, b=2)["mask"]):
        Image.fromarray(np.repeat(m[..., None] * 255, 3, -1)
                        ).save(d / f"m{i}.png")
    out["mask"] = str(d)
    return out


def _datasets(dirs, cls=InpaintDataset):
    return (cls(dirs["img"], dirs["mask"], dirs["ref"], S, seed=3),
            cls(dirs["val"], dirs["mask"], dirs["ref"], S, seed=4))


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def fitted(dirs, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    _, cfg = configs(**dict(FIELDS, niter=1, niter_decay=1, lr_policy="step",
                            lr_decay_iters=1, display_freq=4,
                            metrics_every=3, checkpoints_dir=ck))
    tr = Trainer(cfg, *_datasets(dirs), device="cpu")
    return cfg, tr, tr.fit(profile_dir=os.path.join(ck, "trace"))


def test_fit_two_epochs(fitted):
    cfg, tr, state = fitted
    assert state.step == 4                         # 2 epochs x 2 steps
    # fit(profile_dir=...) leaves a Chrome trace of the run
    with open(os.path.join(cfg.checkpoints_dir, "trace", "trace.json")) as f:
        assert "traceEvents" in f.read(4096)
    rows = _rows(tr.logger.path)
    assert [int(r["step"]) for r in rows] == [2, 4, 6, 8]   # images so far
    for r in rows:
        assert all(np.isfinite(float(r[k]))
                   for k in ("G_GAN", "G_L1", "D", "F", "cosis", "loss"))
    assert tr.ckpt.all_epochs() == [1, 2]
    assert os.path.exists(os.path.join(tr.out_dir, "loss_plot.png"))
    assert sorted(os.listdir(os.path.join(tr.out_dir, "saveimg"))) == [
        "Epoch_(1)_(4).jpg", "Epoch_(2)_(8).jpg"]
    assert len(tr.logger.epoch_valid) == 2
    assert all(np.isfinite(tr.logger.epoch_valid))


def test_learning_rate_steps_once_an_epoch(fitted):
    """The reference saves an epoch before it steps the schedule: epoch e's
    checkpoint holds the rate that epoch trained with."""
    cfg, tr, state = fitted
    assert current_learning_rate(state) == pytest.approx(
        lr_for_epoch(cfg, 2), rel=1e-12)
    for epoch, lr in ((1, cfg.lr), (2, lr_for_epoch(cfg, 1))):
        saved = torch.load(tr.ckpt.path(epoch), weights_only=True)
        assert saved["opt_G"]["param_groups"][0]["lr"] == pytest.approx(lr)
    assert lr_for_epoch(cfg, 1) == pytest.approx(0.1 * cfg.lr)


def test_resume_latest_runs_only_the_remaining_epoch(fitted, dirs):
    cfg, _, state = fitted
    cfg3 = cfg.replace(continue_train=True, which_epoch="latest",
                       niter_decay=2)
    tr = Trainer(cfg3, *_datasets(dirs), device="cpu")
    assert tr.resume_epoch() == 2
    resumed = tr.init_state()
    assert resumed.step == 4
    for k, v in state.G.state_dict().items():
        assert torch.equal(resumed.G.state_dict()[k], v), k
    out = tr.fit(state=resumed)
    assert out.step == 6                           # epoch 3 only
    assert tr.ckpt.all_epochs() == [1, 2, 3]
    assert [int(r["step"]) for r in _rows(tr.logger.path)] == [2, 4]
    assert current_learning_rate(out) == pytest.approx(lr_for_epoch(cfg3, 3))


def test_resume_without_checkpoints_raises(dirs, tmp_path):
    _, cfg = configs(**dict(FIELDS, continue_train=True,
                            which_epoch="latest",
                            checkpoints_dir=str(tmp_path)))
    tr = Trainer(cfg, _datasets(dirs)[0], device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tr.resume_epoch()


def test_debug_nan_guard_halts_on_windowed_flush(dirs, tmp_path):
    """A non-finite loss raises FloatingPointError naming the step, at the
    flush of the metrics window; without debug_nan it is only logged."""
    for debug_nan in (True, False):
        ck = str(tmp_path / str(debug_nan))
        _, cfg = configs(**dict(FIELDS, debug_nan=debug_nan,
                                metrics_every=10, checkpoints_dir=ck))
        tr = Trainer(cfg, _datasets(dirs)[0], device="cpu")
        calls = []

        def bad_step(state, batch, generator):   # no work; poisoned metrics
            calls.append(batch["image"].shape)
            loss = float("nan") if len(calls) == 2 else 1.0
            return state, {"loss": torch.tensor(loss), "D": torch.tensor(0.)}

        tr.train_step = bad_step
        if debug_nan:
            with pytest.raises(FloatingPointError,
                               match="non-finite loss at step 4"):
                tr.train_epoch(None, 1, 0)
        else:
            _, loss, steps = tr.train_epoch(None, 1, 0)
            assert np.isnan(loss) and steps == 4
        assert len(calls) == 2                    # the whole window ran


def test_single_device_only(dirs, tmp_path):
    """sp_devices that do not divide the world (one process here) are
    refused with the JAX package's message, the text its Trainer gives on
    its 8 virtual devices (parallel/mesh.py::grid_shape)."""
    jcfg, cfg = configs(**dict(FIELDS, sp_devices=2,
                               checkpoints_dir=str(tmp_path)))
    with pytest.raises(ValueError) as got:
        Trainer(cfg, _datasets(dirs)[0], device="cpu")
    assert str(got.value) == "sp_devices=2 must divide the device count (1)"
    with pytest.raises(ValueError) as want:
        JTrainer(jcfg.replace(sp_devices=3), None)
    with pytest.raises(ValueError) as got:
        mesh.grid_shape(cfg.batch_size, len(jax.devices()), 3)
    assert str(got.value) == str(want.value)


def test_one_epoch_matches_jax_trainer(dirs, tmp_path):
    fields = dict(FIELDS, faithful_backward_truncation=False, display_freq=0)
    jcfg, tcfg = configs(**dict(fields,
                                checkpoints_dir=str(tmp_path / "j")))
    tcfg = tcfg.replace(checkpoints_dir=str(tmp_path / "t"))
    params = jax_params(jcfg, seed=7)
    flats = flat_dicts(params, tmp_path)

    jtr = JTrainer(jcfg, _datasets(dirs, JInpaintDataset)[0])
    jstate = pmesh.replicate_state(JST.create_train_state(jcfg, params),
                                   jtr.mesh)
    jtr.train_epoch(jstate, 1, jax.random.PRNGKey(0), 0)
    jtr.logger.close()

    ttr = Trainer(tcfg, _datasets(dirs)[0], device="cpu")
    state, _, steps = ttr.train_epoch(torch_state(tcfg, flats), 1, 0)
    ttr.logger.close()
    assert steps == 4 and state.step == 2

    want, got = _rows(jtr.logger.path), _rows(ttr.logger.path)
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["2", "4"]
    for g, w in zip(got, want):
        for k in ("G_L1", "G_GAN", "D", "F"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3,
                                       err_msg=f"step {g['step']} {k}")
