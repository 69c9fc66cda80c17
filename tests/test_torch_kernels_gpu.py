"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card: it carries the `gpu` marker and skips
where none is present.  The file imports no JAX, so it also runs where JAX
is not installed; tests/conftest.py imports JAX, so run it as

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from deepinpainting_torch.config import Config
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import attention as TA
from deepinpainting_torch.ops import attention_cuda as TAC

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scan_inputs(b, n, c, starts, seed):
    rng = np.random.default_rng(seed)
    pn = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    pn = pn / pn.norm(dim=2, keepdim=True)
    known = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    vmax = torch.from_numpy(rng.random((b, n)).astype(np.float32) + 0.5)
    flag = torch.zeros(b, n)
    for s in starts:
        flag[:, s:s + 3] = 1
    return flag, vmax, pn, known


@pytest.mark.parametrize("c", [64, 128, 200, 512, 1024])
def test_kernel_matches_plain(cuda, c):
    """Short chains (9 masked positions), C from the tiny config's 64 to
    the kernel's limit: both round the f64 dot product once to f32, so
    they agree to far better than the short-chain limit of 2e-3."""
    args = [t.to(cuda).contiguous()
            for t in _scan_inputs(4, 1024, c, (100, 400, 900), seed=c)]
    before = TAC.launches
    got = TAC.scan_stream_cuda(*args)
    want = TA.scan_stream_reference(*args)
    torch.cuda.synchronize()
    assert TAC.launches == before + 1
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 2e-3
    um = args[0] == 0
    assert torch.equal(got[0][um], args[3][um])
    assert bool((got[1][um] == 1).all()) and bool((got[2][um] == 0).all())


def test_kernel_refuses_bad_inputs(cuda):
    flag, vmax, pn, known = (t.to(cuda) for t in
                             _scan_inputs(2, 8, 128, (2,), seed=0))
    with pytest.raises(ValueError):
        TAC.scan_stream_cuda(flag, vmax, pn.double(), known)
    with pytest.raises(ValueError):
        TAC.scan_stream_cuda(flag, vmax, pn[:, :, :66].contiguous(),
                             known[:, :, :66].contiguous())
    with pytest.raises(ValueError):
        TAC.scan_stream_cuda(flag, vmax,
                             pn.transpose(1, 2).contiguous().transpose(1, 2),
                             known)


def test_tiny_serving_on_card_matches_cpu(cuda):
    """The whole two-stage forward at a small config: on the card through
    the kernel, on the CPU through the plain version, same weights."""
    cfg = Config(fine_size=64, ngf=8, vgg_width_scale=1 / 8)
    cpu = TI.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = TI.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    mask = np.zeros((2, 64, 64), np.uint8)
    mask[:, 20:40, 24:40] = 1
    before = TAC.launches
    got, _ = TI.make_inference_fn(cfg, cuda)(*gpu, gt, mask, ref)
    want, _ = TI.make_inference_fn(cfg, "cpu")(*cpu, gt, mask, ref)
    assert TAC.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3)
