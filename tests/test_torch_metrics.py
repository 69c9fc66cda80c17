"""Port vs JAX: PSNR, SSIM and the metrics logger (utils/metrics.py), and
the profiling and parameter-count helpers (utils/profiling.py, params.py).

The port's psnr/ssim return one value per image of an NCHW batch; the JAX
package's return one value for whatever batch they are given, and its eval
step calls them per image.  So each port value is held against the JAX
function on that image alone, and the batch mean of the port's SSIM
against the JAX SSIM of the whole batch (equal-size images: the same
mean).  Tolerance 1e-5 (f32, a handful of depthwise 11x11 filters) for
both; SSIM is also held to 1e-4 against tests/test_ssim_golden.py's
line-by-line reimplementation of IQA_pytorch, the limit that file uses.
"""

import csv

import numpy as np
import pytest
import torch
from PIL import Image

from deepinpainting_tpu.utils.metrics import psnr as jpsnr
from deepinpainting_tpu.utils.metrics import ssim as jssim
from deepinpainting_torch.utils.metrics import MetricsLogger, psnr, ssim

from test_ssim_golden import _pairs, iqa_ssim_golden


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _batch(seed, b=3, s=48, noise=0.2):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, noise, real.shape), -1, 1
                   ).astype(np.float32)
    return real, fake


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psnr_and_ssim_match_jax_per_image(seed):
    real, fake = _batch(seed, noise=0.05 + 0.2 * seed)
    got_p = psnr(_nchw(real), _nchw(fake)).numpy()
    got_s = ssim(_nchw(real), _nchw(fake)).numpy()
    assert got_p.shape == got_s.shape == (3,)
    for i in range(3):
        np.testing.assert_allclose(got_p[i], float(jpsnr(real[i:i + 1],
                                                         fake[i:i + 1])),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_s[i], float(jssim(real[i:i + 1],
                                                         fake[i:i + 1])),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_s.mean(), float(jssim(real, fake)),
                               rtol=0, atol=1e-5)


def test_psnr_of_identical_images_is_100():
    real, _ = _batch(3, b=2)
    x = _nchw(real)
    fake = x.clone()
    fake[1] += 0.1                     # one image identical, one not
    got = psnr(x, fake)
    assert float(got[0]) == 100.0
    assert float(got[1]) == pytest.approx(10 * np.log10(4 / 0.01), abs=1e-3)


def test_ssim_relu_clamp_is_active():
    """Anticorrelated images: IQA_pytorch's relu on the contrast-structure
    map clamps every patch to 0, where the plain formula is negative."""
    real, _ = _batch(4, b=1, s=32)
    got = float(ssim(_nchw(real), _nchw(-real))[0])
    assert 0.0 <= got < 0.05
    assert got == pytest.approx(float(jssim(real, -real)), abs=1e-5)


@pytest.mark.parametrize("name,x,y", list(_pairs()))
def test_ssim_matches_iqa_pytorch_golden(name, x, y):
    golden = float(iqa_ssim_golden(_nchw(x), _nchw(y))[0])
    assert float(ssim(_nchw(x), _nchw(y))[0]) == pytest.approx(
        golden, abs=1e-4), name


def test_metrics_logger_csv_epochs_and_plot(tmp_path, capsys):
    log = MetricsLogger(str(tmp_path / "out"))
    log.log_step(8, {"loss": 1.5, "D": 0.25}, when=123.0)
    log.log_step(16, {"loss": 1.25, "D": 0.5})
    log.log_epoch(1, 1.5, 2.0)
    log.log_epoch(2, 1.25, float("nan"))
    log.log_epoch(3, 1.0, 1.5)
    path = log.save_loss_plot()
    log.close()
    log.close()                               # closing twice is harmless
    with open(log.path) as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["8", "16"]
    assert rows[0]["time"] == "123.0" and float(rows[1]["time"]) > 1e9
    assert float(rows[1]["loss"]) == 1.25 and float(rows[0]["D"]) == 0.25
    assert "Epoch : 2 -> Train loss : 1.250000, Valid loss : nan" in (
        capsys.readouterr().out)
    with Image.open(path) as im:
        assert im.size == (800, 640)
        px = np.asarray(im.convert("RGB"))
    # both curves and the early-stop marker are drawn
    for color in ((31, 119, 180), (255, 127, 14), (255, 0, 0)):
        assert (px == color).all(-1).any(), color
    assert MetricsLogger(str(tmp_path / "empty")).save_loss_plot() is None


def test_profiling_and_parameter_counts(tmp_path, capsys):
    from deepinpainting_tpu.utils.params import count_params as jcount
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.utils.params import (count_params,
                                                   print_network,
                                                   summarize_state)
    from deepinpainting_torch.utils.profiling import trace
    from torch_port_helpers import configs, jax_params

    with trace("") as prof:                   # falsy: no profiler
        assert prof is None
    with trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").exists()

    jcfg, tcfg = configs()
    state = TI.create_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    counts = summarize_state(state)
    params = jax_params(jcfg)
    assert counts == {n: jcount(params[n]) for n in counts}
    assert print_network(state.G, "G") == count_params(state.G)
    assert f"[G] Total number of parameters: {counts['G']}" in (
        capsys.readouterr().out)
