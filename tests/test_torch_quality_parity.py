"""Real-asset quality parity of the port against the reference's
published numbers (the port's counterpart of tests/test_quality_parity.py)
-- skipping until the assets exist.

The reference's headline quality is PSNR 25.82 / SSIM 0.772 over the first
500 Paris StreetView test images with random irregular masks at the
epoch-60 checkpoint (test.ipynb cell 3; BASELINE.md).  Neither the data
nor pretrained VGG16 weights are in the repository, and nothing here
downloads them.  The same variables as the JAX package's test turn these
on:

    VGG16_NPZ    torchvision's vgg16 converted to the npz layout:
                 python -m deepinpainting_torch.convert.vgg_import in.pth
                 out.npz (the same file as the JAX package's converter's)
    PARIS_DATA   the dataset root, with test/ and mask/ image directories
    PARITY_CKPT  a checkpoints_dir holding the port's run 'paris' (its
                 config.json and epoch_60.pt, from `_cli train --name paris
                 --vgg_weights $VGG16_NPZ`, or the reference's .pt files
                 brought in with convert/net_import.py and saved by
                 CheckpointManager); PARITY_EPOCH picks another epoch

The networks run on the card when there is one, else on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from deepinpainting_torch.config import Config

VGG16_NPZ = os.environ.get("VGG16_NPZ", "")
PARIS_DATA = os.environ.get("PARIS_DATA", "")
PARITY_CKPT = os.environ.get("PARITY_CKPT", "")
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.skipif(not VGG16_NPZ, reason="set VGG16_NPZ to a converted "
                    "torchvision vgg16 .npz (convert/vgg_import.py)")
def test_pretrained_vgg_npz_loads_and_runs():
    """The converted weights load into the port's extractor and give the
    documented feature shapes (models/vgg16.py's slices)."""
    from deepinpainting_torch.engine.inpaint import init_params
    cfg = Config(vgg_weights=VGG16_NPZ)
    vgg = init_params(cfg, torch.Generator().manual_seed(0), DEVICE).vgg
    with torch.no_grad():
        feats = vgg(torch.zeros(1, 3, 256, 256, device=DEVICE))
    assert feats.relu3_3.shape == (1, 256, 32, 32)
    assert feats.relu4_3.shape == (1, 512, 32, 32)
    assert np.isfinite(feats.relu4_3.cpu().numpy()).all()


@pytest.mark.skipif(not (VGG16_NPZ and PARIS_DATA and PARITY_CKPT),
                    reason="set VGG16_NPZ + PARIS_DATA + PARITY_CKPT to run "
                    "the 500-image quality-parity evaluation")
def test_quality_parity_500_images():
    """The reference protocol (test.ipynb cell 3): the first 500 test
    images, ref = the image itself, the epoch-60 checkpoint.  The target
    and slack of tests/test_quality_parity.py: 25.82 dB / 0.772, at least
    25.3 / 0.76."""
    from deepinpainting_torch.data.dataset import SelfRefDataset
    from deepinpainting_torch.engine import create_state
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.engine.evaluator import evaluate

    cfg = Config(fine_size=256, batch_size=4, vgg_weights=VGG16_NPZ,
                 checkpoints_dir=PARITY_CKPT, name="paris",
                 mask_type="random", is_train=False)
    state = create_state(cfg, torch.Generator().manual_seed(0), DEVICE)
    epoch = int(os.environ.get("PARITY_EPOCH", "60"))
    state = CheckpointManager(cfg).restore(epoch, state, DEVICE)
    ds = SelfRefDataset(os.path.join(PARIS_DATA, "test"),
                        os.path.join(PARIS_DATA, "mask"), fine_size=256)
    res = evaluate(cfg, state, ds, max_images=500, device=DEVICE)
    assert res["images"] == 500
    assert res["psnr"] >= 25.3, res
    assert res["ssim"] >= 0.76, res
