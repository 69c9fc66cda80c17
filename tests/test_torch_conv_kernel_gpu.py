"""The hand-written f32 convolution (csrc/conv2d.cu) on the card, at every
shape ops/convs.py routes to it in the benchmark's configurations: the 256
px f32 train step (each kernel-4 Conv2d forward and each ConvTranspose2d
input gradient), the 512 px bf16 step (netD's and netF's f32 forwards) and
256 px serving at batches 1 and 8 (the U-Nets' kernel-4 down convs), at
full width.

Every test here needs a CUDA card: it carries the `gpu` marker and skips
where none is present.  The file imports no JAX; tests/conftest.py does,
so run it as

    python -m pytest tests/test_torch_conv_kernel_gpu.py -q --noconftest
"""

import math

import pytest
import torch
import torch.nn.functional as F

from deepinpainting_torch.ops import conv_cuda
from deepinpainting_torch.ops.convs import HandConv2d, HandConvTranspose2d

from torch_conv_shapes import gemm, routed_calls

pytestmark = pytest.mark.gpu


def _shapes():
    """Every routed (kind, geometry) of the cells, once each."""
    seen = {}
    for px, batch, nets, kinds in ((256, 8, "GPDF", ("fwd", "dgrad")),
                                   (512, 8, "DF", ("fwd",)),
                                   (256, 8, "GP", ("fwd",)),
                                   (256, 1, "GP", ("fwd",))):
        for _, kind, geo in routed_calls(px, batch, nets):
            if kind in kinds:
                seen[(kind, geo)] = None
    return list(seen)


SHAPES = _shapes()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(geo, bias, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w, n, k = geo[:6]
    x = torch.randn(b, c, h, w, generator=g, device=dev)
    wt = torch.randn(n, c, k, k, generator=g, device=dev) / math.sqrt(c * k * k)
    bs = torch.randn(n, generator=g, device=dev) if bias else None
    return x, wt, bs


@pytest.mark.parametrize("kind, geo", SHAPES,
                         ids=[f"{k}-{'x'.join(map(str, g))}" for k, g in SHAPES])
def test_kernel_against_float64_and_cudnn(cuda, kind, geo):
    """The kernel's largest error against a float64 convolution is at
    most twice cuDNN's own f32 error on the same operands (TF32 off), so
    a TF32 or other reduced operand fails; two launches agree bit for
    bit."""
    s, p, d = geo[6:]
    x, wt, bias = _operands(geo, kind == "fwd", cuda, seed=sum(geo))
    before = conv_cuda.launches
    got = conv_cuda.conv2d_f32_cuda(x, wt, bias, s, p, d)
    again = conv_cuda.conv2d_f32_cuda(x, wt, bias, s, p, d)
    lib = F.conv2d(x, wt, bias, s, p, d)
    want = F.conv2d(x.double(), wt.double(),
                    None if bias is None else bias.double(), s, p, d)
    torch.cuda.synchronize()
    assert conv_cuda.launches == before + 2
    assert got.shape == want.shape
    err = (got.double() - want).abs().max().item()
    lib_err = (lib.double() - want).abs().max().item()
    assert err <= 2 * lib_err, (err, lib_err, gemm(geo))
    assert torch.equal(got, again)


def _one_of_each_geometry():
    """A routed shape of each (kind, kernel, stride, dilation), the one
    with the GEMM rows nearest 8192 (whole tiles, a few waves): netP's and
    netG's down convs, netD's stride-1 conv, the transposed convs' k4 and
    k3 input gradients."""
    best = {}
    for kind, geo in SHAPES:
        key = (kind, geo[5], geo[6], geo[8])
        far = abs(math.log2(gemm(geo)[0]) - 13)
        if key not in best or far < best[key][0]:
            best[key] = (far, geo)
    return [(key[0], geo) for key, (_, geo) in sorted(best.items())]


GRAD_SHAPES = _one_of_each_geometry()


@pytest.mark.parametrize("kind, geo", GRAD_SHAPES,
                         ids=[f"{k}-{'x'.join(map(str, g))}"
                              for k, g in GRAD_SHAPES])
def test_autograd_functions_match_aten(cuda, kind, geo):
    """Both autograd.Functions against aten's own layer: the forward and
    every gradient within f32 reordering (the hand-written path differs
    from cuDNN's in the order of its sums only)."""
    s, p, d = geo[6:]
    x, wt, bias = _operands(geo, True, cuda, seed=7)
    if kind == "fwd":
        args = (x.requires_grad_(), wt.requires_grad_(), bias.requires_grad_())
        mine = HandConv2d.apply(*args, s, p, d)
        ref = F.conv2d(*args, s, p, d)
    else:
        # the transposed conv whose input gradient is this conv2d: its
        # input is the conv2d's output, its weight the same tensor
        b, c, n = geo[0], geo[1], geo[4]
        xt = torch.randn(b, n, *_out_hw(geo), device=cuda)
        bt = torch.randn(c, device=cuda)
        args = (xt.requires_grad_(), wt.requires_grad_(), bt.requires_grad_())
        mine = HandConvTranspose2d.apply(*args, s, p)
        ref = F.conv_transpose2d(*args, s, p)
    gy = torch.randn_like(ref)
    got = torch.autograd.grad(mine, args, gy)
    want = torch.autograd.grad(ref, args, gy)
    for g, w in [(mine, ref), *zip(got, want)]:
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-5 * scale


def _out_hw(geo):
    b, c, h, w, n, k, s, p, d = geo
    return (conv_cuda.out_size(h, k, s, p, d),
            conv_cuda.out_size(w, k, s, p, d))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 4, 8, 8, device=cuda)
    w = torch.randn(8, 4, 4, 4, device=cuda)
    with pytest.raises(ValueError):
        conv_cuda.conv2d_f32_cuda(x.double(), w.double(), None, 2, 1, 1)
    with pytest.raises(ValueError):
        conv_cuda.conv2d_f32_cuda(x.cpu(), w, None, 2, 1, 1)
    with pytest.raises(ValueError):
        conv_cuda.conv2d_f32_cuda(x.transpose(2, 3), w, None, 2, 1, 1)
    with pytest.raises(ValueError):
        conv_cuda.conv2d_f32_cuda(x, w[:, :, :3], None, 2, 1, 1)
    with pytest.raises(ValueError):
        conv_cuda.conv2d_f32_cuda(x, w, torch.zeros(3, device=cuda), 2, 1, 1)
