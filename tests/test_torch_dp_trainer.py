"""The training program data-parallel: a two-rank Trainer.fit on the CPU
(gloo), its checkpoint, the resume, evaluate() in the group, and
`_cli.py train --multihost`.

Two spawned ranks fit 2 epochs of 2 steps at global batch 4 (tiny config,
8 training images, 6 validation images, masks with small holes, a
constant learning rate), then
restore the epoch-2 checkpoint, resume for epoch 3 and evaluate the 6
validation images (two global batches, the second padded).  Rank 0 alone
writes; both ranks compute the same validation losses and evaluate()
results, and those equal one process's on the same state and images:
per-image PSNR within 1e-4 dB and SSIM within 1e-6 (each image's forward
runs in a batch of 2 on a rank and of 4 in one process, so the convs sum
in another order).
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dp_workers as W
from deepinpainting_torch import _cli
from deepinpainting_torch.config import Config
from deepinpainting_torch.data import InpaintDataset, SelfRefDataset
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine.checkpoint import CheckpointManager
from deepinpainting_torch.engine.evaluator import evaluate
from deepinpainting_torch.engine.trainer import Trainer

from torch_port_helpers import TINY, tiny_batch

REPO = Path(__file__).resolve().parent.parent
S = 64


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpdata")
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
    return Config(**dict(TINY, batch_size=4, niter=2, niter_decay=0,
                         lr_policy="step", lr_decay_iters=100,
                         save_epoch_freq=1, display_freq=8, metrics_every=1,
                         data_workers=0, use_dropout=False,
                         mask_type="random", seed=3, checkpoints_dir=str(ck),
                         name="dp", **kw))


@pytest.fixture(scope="module")
def fitted(dirs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dpfit")
    cfg = _config(tmp / "ck")
    ranks = tmp / "ranks"
    ranks.mkdir()
    W.run_ranks(W.dp_fit, 2, ranks, cfg, dirs)
    return cfg, [torch.load(ranks / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_rank_0_alone_writes(fitted):
    cfg, (r0, r1) = fitted
    assert (r0["writes"], r1["writes"]) == (3, 0)     # epochs 1, 2, 3
    out = os.path.join(cfg.checkpoints_dir, cfg.name)
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        "epoch_1.pt", "epoch_2.pt", "epoch_3.pt"]
    assert os.path.exists(os.path.join(out, "config.json"))
    # one row a step, counting global images; the resume starts a new file
    assert [int(r["step"]) for r in _rows(os.path.join(out, "metrics.csv"))
            ] == [4, 8]
    assert sorted(os.listdir(os.path.join(out, "saveimg"))) == [
        "Epoch_(1)_(8).jpg", "Epoch_(2)_(16).jpg", "Epoch_(3)_(8).jpg"]


def test_ranks_hold_half_of_each_batch(fitted):
    _, (r0, r1) = fitted
    assert (r0["rows"], r1["rows"]) == ((0, 2), (2, 4))


def test_ranks_compute_the_same_validation_loss(fitted):
    _, (r0, r1) = fitted
    assert len(set(r0["valid"])) == 3 and all(np.isfinite(r0["valid"]))
    assert r0["valid"] == r1["valid"]


def test_every_rank_restores_the_checkpoint_bit_for_bit(fitted):
    """Each rank's restore of rank 0's file equals its own trained state:
    the ranks' states are the same, bit for bit."""
    _, ranks = fitted
    assert [r["restored_bit_for_bit"] for r in ranks] == [True, True]


def test_resume_runs_the_remaining_epoch(fitted):
    _, ranks = fitted
    for r in ranks:
        assert r["epochs"] == [1, 2, 3]
        assert (r["steps"], r["resumed_steps"]) == (4, 6)


def test_two_rank_evaluate_equals_one_process(fitted, dirs):
    cfg, (r0, r1) = fitted
    assert r0["evaluate"] == r1["evaluate"]
    state = TI.create_state(cfg, torch.Generator().manual_seed(0), "cpu")
    CheckpointManager(cfg.replace(is_train=False)).restore(3, state, "cpu")
    want = evaluate(cfg.replace(is_train=False), state,
                    SelfRefDataset(dirs["val"], dirs["mask"], S),
                    device="cpu", verbose=False, return_per_image=True)
    got = r0["evaluate"]
    assert got["images"] == want["images"] == 6
    np.testing.assert_allclose(got["psnr_per_image"],
                               want["psnr_per_image"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssim_per_image"],
                               want["ssim_per_image"], rtol=0, atol=1e-6)


def test_one_process_resumes_the_two_rank_checkpoint(fitted, dirs):
    cfg, _ = fitted
    cfg4 = cfg.replace(continue_train=True, which_epoch="latest", niter=4)
    tr = Trainer(cfg4, InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"],
                                      S, seed=cfg.seed), device="cpu")
    assert tr.resume_epoch() == 3 and tr.group is None
    assert tr.fit().step == 8
    assert tr.ckpt.all_epochs() == [1, 2, 3, 4]


def _train_args(dirs, ck):
    return ["--dataroot", dirs["img"], "--maskroot", dirs["mask"],
            "--refroot", dirs["ref"], "--device", "cpu", "--fine_size",
            str(S), "--ngf", "8", "--ndf", "8", "--vgg_width_scale",
            "0.125", "--batch_size", "4", "--niter", "1", "--niter_decay",
            "0", "--data_workers", "0", "--mask_type", "random",
            "--checkpoints_dir", str(ck), "--name", "cli"]


def test_multihost_flags_are_all_or_none(dirs, tmp_path, capsys):
    for given in (["--coordinator", "localhost:1234"],
                  ["--process_id", "1"],
                  ["--num_processes", "2", "--process_id", "0"]):
        with pytest.raises(SystemExit) as exc:
            _cli.train(_train_args(dirs, tmp_path) + ["--multihost"] + given)
        assert exc.value.code == 2
        assert "must be given together" in capsys.readouterr().err


def test_cli_multihost_trains_two_ranks(dirs, tmp_path):
    """Two `_cli train --multihost --device cpu` processes meet through
    the coordinator trio and train one epoch together."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    rendezvous = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deepinpainting_torch._cli", "train"]
        + _train_args(dirs, tmp_path / "ck")
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
    assert "multihost: process 0/2, device cpu, backend gloo" in outs[0]
    assert "multihost" not in outs[1]
    run = tmp_path / "ck" / "cli"
    assert sorted(os.listdir(run)) == [
        "config.json", "epoch_1.pt", "loss_plot.png", "metrics.csv"]
    assert [int(r["step"]) for r in _rows(run / "metrics.csv")] == [4, 8]
