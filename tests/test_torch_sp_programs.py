"""The programs spatially partitioned, on two gloo ranks on the CPU: a
Trainer.fit with sp_devices=2, its checkpoint, restore and resume,
evaluate() in the grid, `_cli.py train --multihost --sp_devices 2`, and
InferenceSession(sp=True); then the grid's divisibility rules.

The fit: 1 epoch of 2 steps at global batch 4 (tiny config, 8 training
images, 6 validation images, masks with small holes, a constant learning
rate), the epoch-1 checkpoint restored, a resume for epoch 2, and
evaluate() of the 6 validation images (two global batches, the second
padded).  Both ranks hold all 4 rows of each batch and 32 of their 64
rows; rank 0 alone writes.  evaluate() equals one process's on the same
state and images: per-image PSNR within 1e-4 dB and SSIM within 1e-6 (the
slabs' convs sum in another order; test_torch_dp_trainer.py's limits).
The sp session's uint8 answers equal the plain session's within 1 level,
on all but 0.1% of the values at most (test_torch_serving.py's rule for
the same arithmetic in another order).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dp_workers as W
from deepinpainting_torch.config import Config
from deepinpainting_torch.data import SelfRefDataset
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine.checkpoint import CheckpointManager
from deepinpainting_torch.engine.evaluator import evaluate
from deepinpainting_torch.parallel import mesh
from deepinpainting_torch.serve.app import InferenceSession

from torch_port_helpers import TINY, tiny_batch

REPO = Path(__file__).resolve().parent.parent
S = 64


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spdata")
    out = {}
    for name, n, seed in (("img", 8, 0), ("ref", 8, 1), ("val", 6, 2)):
        out[name] = str(root / name)
        W.make_images(out[name], n, S, seed)
    out["mask"] = str(root / "mask")
    os.makedirs(out["mask"])
    for i, m in enumerate(tiny_batch(0, b=2)["mask"]):
        Image.fromarray(np.repeat(m[..., None] * 255, 3, -1)).save(
            os.path.join(out["mask"], f"m{i}.png"))
    return out


def _config(ck, **kw):
    return Config(**dict(TINY, batch_size=4, niter=1, niter_decay=0,
                         lr_policy="step", lr_decay_iters=100,
                         save_epoch_freq=1, display_freq=8, metrics_every=1,
                         data_workers=0, use_dropout=False,
                         mask_type="random", seed=3, sp_devices=2,
                         checkpoints_dir=str(ck), name="sp", **kw))


@pytest.fixture(scope="module")
def fitted(dirs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spfit")
    cfg = _config(tmp / "ck")
    ranks = tmp / "ranks"
    ranks.mkdir()
    W.run_ranks(W.dp_fit, 2, ranks, cfg, dirs)
    return cfg, [torch.load(ranks / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]


def test_fit_rank_0_alone_writes(fitted):
    cfg, (r0, r1) = fitted
    assert (r0["writes"], r1["writes"]) == (2, 0)     # epochs 1, 2
    out = os.path.join(cfg.checkpoints_dir, cfg.name)
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        "epoch_1.pt", "epoch_2.pt"]
    assert sorted(os.listdir(os.path.join(out, "saveimg"))) == [
        "Epoch_(1)_(8).jpg", "Epoch_(2)_(8).jpg"]
    # the visual dump shows whole images: a 2x2 grid of S x S tiles (a
    # slab's would be half as high)
    with Image.open(os.path.join(out, "saveimg", "Epoch_(1)_(8).jpg")) as im:
        assert im.size[0] == im.size[1] > 2 * S


def test_fit_ranks_hold_every_row_and_agree(fitted):
    """One data group of two slabs: each rank decodes all 4 rows of a
    batch (and keeps 32 of their rows); both compute the same validation
    losses, restore rank 0's file bit for bit and resume epoch 2."""
    _, ranks = fitted
    for r in ranks:
        assert r["rows"] == (0, 4)
        assert r["restored_bit_for_bit"]
        assert r["epochs"] == [1, 2]
        assert (r["steps"], r["resumed_steps"]) == (2, 4)
    assert len(set(ranks[0]["valid"])) == 2
    assert all(np.isfinite(ranks[0]["valid"]))
    assert ranks[0]["valid"] == ranks[1]["valid"]


def test_sp_evaluate_equals_one_process(fitted, dirs):
    cfg, (r0, r1) = fitted
    assert r0["evaluate"] == r1["evaluate"]
    state = TI.create_state(cfg, torch.Generator().manual_seed(0), "cpu")
    CheckpointManager(cfg.replace(is_train=False)).restore(2, state, "cpu")
    want = evaluate(cfg.replace(is_train=False), state,
                    SelfRefDataset(dirs["val"], dirs["mask"], S),
                    device="cpu", verbose=False, return_per_image=True)
    got = r0["evaluate"]
    assert got["images"] == want["images"] == 6
    np.testing.assert_allclose(got["psnr_per_image"],
                               want["psnr_per_image"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssim_per_image"],
                               want["ssim_per_image"], rtol=0, atol=1e-6)


def test_cli_multihost_trains_a_grid(dirs, tmp_path):
    """Two `_cli train --multihost --sp_devices 2 --device cpu` processes
    meet through the coordinator trio and train one epoch, one image's
    rows over both."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    rendezvous = f"file://{tmp_path}/rendezvous"
    args = ["--dataroot", dirs["img"], "--maskroot", dirs["mask"],
            "--refroot", dirs["ref"], "--device", "cpu", "--fine_size",
            str(S), "--ngf", "8", "--ndf", "8", "--vgg_width_scale",
            "0.125", "--batch_size", "4", "--niter", "1", "--niter_decay",
            "0", "--data_workers", "0", "--mask_type", "random",
            "--sp_devices", "2", "--checkpoints_dir", str(tmp_path / "ck"),
            "--name", "cli"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deepinpainting_torch._cli", "train"] + args
        + ["--multihost", "--coordinator", rendezvous, "--num_processes",
           "2", "--process_id", str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=W.TIMEOUT_S)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    run = tmp_path / "ck" / "cli"
    assert sorted(os.listdir(run)) == [
        "config.json", "epoch_1.pt", "loss_plot.png", "metrics.csv"]
    assert Config.load(str(run / "config.json")).sp_devices == 2


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = Config(**TINY)
    models = TI.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    rng = np.random.default_rng(5)
    requests = []
    for b, (y0, x0) in ((1, (12, 20)), (2, (30, 8))):
        mask = np.zeros((b, S, S), np.uint8)
        mask[:, y0:y0 + 20, x0:x0 + 24] = 1
        requests.append((rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8),
                         mask,
                         rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)))
    requests.append((requests[0][0].astype(np.float32) / 127.5 - 1.0,
                     requests[0][1].astype(np.float32), requests[0][2]))
    tmp = tmp_path_factory.mktemp("session")
    torch.save({"models": [net.state_dict() for net in models],
                "requests": requests}, tmp / "inputs.pt")
    W.run_ranks(W.sp_session, 2, tmp, cfg)
    plain = InferenceSession(cfg, state=models, device="cpu")
    return ([plain.run(*r) for r in requests],
            [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)])


def test_sp_session_answers_as_the_plain_session(sessions):
    """Rank 0 serves with rank 0's weights (the follower's own were
    replaced), a batch of 1, of 2, and float inputs."""
    want, (r0, _) = sessions
    assert r0["grid"] == (1, 2, 0, 0)
    assert len(r0["answers"]) == len(want)
    for got, exp in zip(r0["answers"], want):
        assert got.dtype == np.uint8 and got.shape == exp.shape
        diff = np.abs(got.astype(np.int16) - exp.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_sp_session_follower_runs_every_call_and_leaves(sessions):
    _, (r0, r1) = sessions
    assert r1["grid"] == (1, 2, 0, 1)
    assert r1["calls"] == r0["calls"] == 3
    assert r1["answers"] == []


@pytest.mark.parametrize("args, message", [
    ((8, 1, 2), r"sp_devices=2 must divide the device count \(1\)"),
    ((8, 6, 4), r"sp_devices=4 must divide the device count \(6\)"),
    ((6, 8, 2), r"the 4 data-parallel groups that sp_devices=2 leaves of 8 "
                r"ranks; the JAX package would use 2 of them"),
    ((4, 8, 2, 2), r"grad_accum=2 microbatches over the 4 data-parallel "
                   r"group\(s\) of sp_devices=2"),
])
def test_grid_divisibility_is_refused_by_name(args, message):
    with pytest.raises(ValueError, match=message):
        mesh.grid_shape(*args)


def test_grid_shapes():
    assert mesh.grid_shape(8, 8, 2) == (4, 2)
    assert mesh.grid_shape(8, 8, 8) == (1, 8)
    assert mesh.grid_shape(8, 4, 2, grad_accum=2) == (2, 2)
