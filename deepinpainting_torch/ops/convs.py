"""Layers at PyTorch geometry (counterpart of deepinpainting_tpu/ops/convs.py).

The JAX package emulates torch's Conv2d/ConvTranspose2d geometry on NHWC;
here they are the native layers on NCHW:

  * Conv2d k4 s2 p1              — halving downsample (netP)
  * Conv2d k4 s2 p3 d2 (dilated) — halving downsample, keeps channels (netG)
  * Conv2d k3 s1 p1              — same-size
  * ConvTranspose2d k4 s2 p1     — doubling upsample
  * ConvTranspose2d k3 s1 p1     — same-size

Weight init draws the same distributions as the JAX package's make_init
(not the same bits: torch and JAX generators differ).  Biases start at 0,
InstanceNorm affine at (1, 0), BatchNorm scale from N(1, gain).  `Dropout`
draws its keep mask from an explicit torch.Generator, so a training run
repeats from a seed.

Compute dtype (Config.dtype): parameters stay f32 and every layer computes
in its input's dtype, as the JAX package's layers do.  Under bf16 a conv
casts its weight to bf16 per call (its gradient reaches the f32 master
weight through the cast), its output is rounded to bf16 and the bias is
added in bf16; the norms keep their statistics in f32.

Conv modes (Config.quant / pack_small_cin / pack_out), chosen per call as
the JAX package's trace-time `conv_modes(cfg)` chooses them: an entry
point runs its body inside `conv_modes(cfg)`, and every Conv2d /
ConvTranspose2d routes in the JAX package's order, int8 (ops/quant.py),
then pack_small_cin, then pack_out, then the direct conv (on a CUDA f32
input with no mode in force, the hand-written kernel of ops/conv_cuda.py
for a kernel-4 Conv2d's forward or a ConvTranspose2d's input gradient,
where conv_cuda.takes the shape; see that section below).  The modes are
held per thread and are no part of any module's state, so state_dicts do
not change.  Autograd may run a backward, and so a checkpointed level's
recompute, in another thread: models/remat.py captures the modes when the
level is called and enters them again for the recompute.

The pack rewrites are exact reassociations of the same sums (identical
products, another order): small-Cin convs pack their taps into channels
(`_conv2d_space_to_depth`, `_conv2d_tap_stack`), high-resolution k3s1
convs and small-Cout deconvs pack 2-4 output pixels into channels
(`_conv2d_hpack2`, `_deconv_dpack4`).  The gates are the JAX package's,
with its constants (module attributes, so tests can lower them).

Spatial partitioning (parallel/spatial.py): in a sharded region
(parallel/collectives.py::current_spatial) a rank holds a slab of rows of
every activation.  A conv then takes its neighbours' rows (`halo_exchange`)
and runs on the padded slab with no H padding of its own: for a conv of
kernel k, stride s, padding p and dilation d, p rows above and
(k-1)d - p - s + 1 below (netP's k4 s2 p1: 1 and 1; netG's k4 s2 p3 d2:
3 and 2; k3 s1 p1: 1 and 1), for a transposed conv (k-1-p)//s input rows
above and (p-1+s)//s below (k4 s2 p1 and k3 s1 p1: 1 and 1), the output
cut to the slab's s*h rows.  A stride-s conv needs a slab height that s
divides; the U-Nets gather the levels where it does not.  The instance
norm sums each (N, C) over every slab (the JAX layer's two reductions),
a train-mode BatchNorm over the whole grid, the dropout draws the whole
image's mask and keeps its rows, and a bilinear resize runs on the
gathered image.  The conv modes run on slabs as in one process, in the
same order: a rewrite pads the halo'd slab's H by nothing (a transposed
conv's takes the layer's padding, and its output is cut as above), the
pack gates read the whole image's height (slab rows times the sp size),
as the JAX package's program does, and int8's scale is the whole
tensor's maximum (ops/quant.py).  A slab whose own rows do not suit a
gated rewrite (hpack2 needs an even count) takes the direct conv, which
computes the same sums.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import (all_reduce_sum, batch_group,
                                    current_spatial, full_rows,
                                    halo_exchange, own_rows, replicated)
from ..utils.profiling import span
from . import conv_cuda, quant

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
NORMS = ("instance", "batch")


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=True): biased variance over H, W per (N, C),
    statistics in f32.  x: [N, C, H, W]; in a sharded region a slab, whose
    sums are taken over every slab of the image."""
    xf = x.to(torch.float32)
    sp = current_spatial()
    if sp is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    else:
        n = xf.shape[2] * xf.shape[3] * sp.size
        mean = all_reduce_sum(xf.sum(dim=(2, 3), keepdim=True), sp.group) / n
        var = all_reduce_sum((xf - mean).square().sum(dim=(2, 3),
                                                     keepdim=True),
                             sp.group) / n
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) with the JAX package's arithmetic."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.eps)


def _channels(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A per-channel vector [C] in `dtype`, shaped to broadcast on NCHW."""
    return v.to(dtype)[:, None, None]


# ---- conv modes -------------------------------------------------------------

class ConvModes(NamedTuple):
    """Which conv rewrites are on (Config.quant == 'int8',
    pack_small_cin, pack_out)."""
    int8: bool = False
    pack_small_cin: bool = False
    pack_out: bool = False


_MODES = threading.local()

_PACK_CIN_MAX = 8
_PACK_OUT_MIN_HW = 128     # direct convs below this size are not packed
_PACK_OUT_MIN_CIN = 32     # tiny-Cin convs are pack_small_cin's regime
_PACK_OUT_DECONV_MAX_COUT = 64


def current_modes() -> ConvModes:
    """The conv modes in force in this thread."""
    return getattr(_MODES, "modes", ConvModes())


@contextlib.contextmanager
def use_modes(modes: ConvModes):
    """Run the block's convs (in this thread) under `modes`."""
    prev = current_modes()
    _MODES.modes = modes
    try:
        yield
    finally:
        _MODES.modes = prev


def modes_of(cfg) -> ConvModes:
    """The conv modes a Config selects."""
    return ConvModes(cfg.quant == "int8", bool(cfg.pack_small_cin),
                     bool(cfg.pack_out))


def conv_modes(cfg):
    """Enter every conv mode a Config selects (the JAX package's
    conv_modes)."""
    return use_modes(modes_of(cfg))


# ---- the pack rewrites (NCHW; weights in torch layout) ---------------------
#
# A rewrite takes its H padding `ph` apart from the layer's `padding`, and
# its gate the whole image's height `full_h` apart from x's: one process
# pads H by the layer's padding (ph None) and holds the whole image
# (full_h None); a slab of rows (spatial partitioning) arrives with its
# halo, pads H by nothing and gates on its rows times the sp size, as the
# JAX package's program, which sees whole images, gates.

def _conv2d_space_to_depth(x, w, padding, ph=None):
    """k4 s2 conv as space-to-depth(2) + a k2 s1 conv: output row h reads
    padded rows 2h..2h+3, the 2x2 blocks h and h+1, so with each block
    packed into channels the window is 2x2 at stride 1 and the reduction
    per tap is 4*Cin wide."""
    n, c = x.shape[:2]
    cout = w.shape[0]
    ph = padding if ph is None else ph
    xp = F.pad(x, (padding, padding, ph, ph))
    h2, w2 = xp.shape[2] // 2, xp.shape[3] // 2
    # channel (c, di, dj) of block (h2, w2)
    x2 = xp.reshape(n, c, h2, 2, w2, 2).permute(0, 1, 3, 5, 2, 4)
    x2 = x2.reshape(n, 4 * c, h2, w2)
    # w[o, c, 2bi+di, 2bj+dj] -> k2[o, (c, di, dj), bi, bj]
    k2 = w.reshape(cout, c, 2, 2, 2, 2).permute(0, 1, 3, 5, 2, 4)
    return F.conv2d(x2, k2.reshape(cout, 4 * c, 2, 2))


def _conv2d_tap_stack(x, w, padding, ph=None):
    """k x k s1 conv as kh*kw shifted tap planes + a 1x1 conv: the
    reduction goes Cin -> kh*kw*Cin."""
    cout, c, kh, kw = w.shape
    ph = padding if ph is None else ph
    xp = F.pad(x, (padding, padding, ph, ph))
    h, wd = xp.shape[2] - kh + 1, xp.shape[3] - kw + 1
    xs = torch.cat([xp[:, :, dh:dh + h, dw:dw + wd]
                    for dh in range(kh) for dw in range(kw)], dim=1)
    # channel order (dh, dw, c) on both sides
    k1 = w.permute(0, 2, 3, 1).reshape(cout, kh * kw * c, 1, 1)
    return F.conv2d(xs, k1)


def _packed_small_cin(x, w, stride, padding, dilation, ph=None,
                      full_h=None):
    """Route an eligible tiny-Cin conv to its packed rewrite, else None.
    Gated on the whole image; x padded by ph must split into 2x2 blocks
    too."""
    _, cin, kh, kw = w.shape
    ph = padding if ph is None else ph
    full_h = x.shape[2] if full_h is None else full_h
    if cin > _PACK_CIN_MAX or dilation != 1 or kh != kw or kh == 1:
        return None
    if stride == 1:
        return _conv2d_tap_stack(x, w, padding, ph)
    if (stride == 2 and kh == 4 and (full_h + 2 * padding) % 2 == 0
            and (x.shape[3] + 2 * padding) % 2 == 0
            and (x.shape[2] + 2 * ph) % 2 == 0):
        return _conv2d_space_to_depth(x, w, padding, ph)
    return None


def _conv2d_hpack2(x, w, ph=1):
    """k3 s1 conv (W padding 1) as a [4, 3] stride-(2, 1) conv packing
    output rows 2i and 2i+1 into 2*Cout channels: output row r of the
    strided conv reads padded rows 2r..2r+3; taps 0..2 of that window give
    row 2r, taps 1..3 row 2r+1 (4/3 the MACs, the extra ones on zeros).
    It reads one zero row past the H padding, under a zero tap.  The
    output's row count (H + 2 ph - 2) must be even."""
    co, c, _, kw = w.shape
    z = w.new_zeros((co, c, 1, kw))
    k2 = torch.cat([torch.cat([w, z], dim=2), torch.cat([z, w], dim=2)])
    n, wd = x.shape[0], x.shape[3]
    y = F.conv2d(F.pad(x, (1, 1, ph, ph + 1)), k2, stride=(2, 1))
    h2 = y.shape[2]
    y = y.reshape(n, 2, co, h2, wd).permute(0, 2, 3, 1, 4)
    return y.reshape(n, co, 2 * h2, wd)


def _hpack2_fits(full_h: int, rows: int) -> bool:
    """hpack2's gate: the whole image is tall and even (the JAX package's
    test), and this call's `rows` of output pair up."""
    return full_h >= _PACK_OUT_MIN_HW and full_h % 2 == 0 and rows % 2 == 0


def _packed_out_conv(x, w, stride, padding, dilation, ph=None, full_h=None):
    """Route an eligible high-resolution k3s1 conv to hpack2, else None
    (gated on the whole image, as _packed_small_cin)."""
    _, cin, kh, kw = w.shape
    ph = padding if ph is None else ph
    full_h = x.shape[2] if full_h is None else full_h
    if (stride != 1 or dilation != 1 or kh != 3 or kw != 3 or padding != 1
            or cin < _PACK_OUT_MIN_CIN
            or not _hpack2_fits(full_h, x.shape[2] + 2 * ph - 2)):
        return None
    # ph 1 is hpack2's own default: one process calls it with (x, w) as it
    # always has, the call that tests/test_torch_pack.py::
    # test_recompute_in_another_thread_takes_the_packed_path spies on
    return _conv2d_hpack2(x, w) if ph == 1 else _conv2d_hpack2(x, w, ph)


def _deconv_dpack4(x, wt):
    """ConvTranspose2d k4 s2 p1 as a k2 s1 conv over pad(x, 1) with the
    2x2 output phase packed into 4*Cout channels (the sub-pixel split; the
    taps are regrouped, no MAC is added).  Per axis:
      out[2m+1] = x[m]*K[2] + x[m+1]*K[0]
      out[2m+2] = x[m]*K[3] + x[m+1]*K[1]
    Both phases read x[m..m+1]; the conv emits m = -1..H-1 and the border
    rows and columns outside the output are sliced off.  wt: [Cin, Cout,
    4, 4]."""
    c, co = wt.shape[:2]
    t = {1: (2, 0), 2: (3, 1)}  # phase -> (tap at m, tap at m+1)
    blocks = []
    for rh in (1, 2):
        for rw in (1, 2):
            blocks.append(torch.stack([
                torch.stack([wt[:, :, t[rh][u], t[rw][v]].t() for v in (0, 1)],
                            dim=-1) for u in (0, 1)], dim=-2))  # [Co, C, 2, 2]
    k2 = torch.cat(blocks)                                     # [4Co, C, 2, 2]
    n, _, h, wd = x.shape
    y = F.conv2d(F.pad(x, (1, 1, 1, 1)), k2)           # [n, 4Co, h+1, w+1]
    y = y.reshape(n, 2, 2, co, h + 1, wd + 1).permute(0, 3, 4, 1, 5, 2)
    y = y.reshape(n, co, 2 * h + 2, 2 * wd + 2)
    return y[:, :, 1:2 * h + 1, 1:2 * wd + 1]


def _packed_out_deconv(x, wt, stride, padding, full_h=None):
    """Route an eligible deconv to its packed rewrite, else None: k4 s2 p1
    with a narrow Cout -> dpack4; k3 s1 p1 is the k3s1p1 conv of the
    flipped, transposed kernel -> hpack2.  Gated on the whole image's
    input height, as _packed_small_cin."""
    cin, cout, kh, kw = wt.shape
    full_h = x.shape[2] if full_h is None else full_h
    if (stride == 2 and padding == 1 and kh == 4 and kw == 4
            and cout <= _PACK_OUT_DECONV_MAX_COUT
            and cin >= _PACK_OUT_MIN_CIN
            and 2 * full_h >= _PACK_OUT_MIN_HW):
        return _deconv_dpack4(x, wt)
    if (stride == 1 and padding == 1 and kh == 3 and kw == 3
            and cin >= _PACK_OUT_MIN_CIN
            and _hpack2_fits(full_h, x.shape[2])):
        return _conv2d_hpack2(x, wt.flip(2, 3).transpose(0, 1))
    return None


def _with_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + _channels(bias, y.dtype)


def _moded_conv2d(x, w, bias, stride, ph, padding, dilation, full_h):
    """The conv under the conv modes in force, in the JAX package's order
    (int8, pack_small_cin, pack_out), or None for the direct conv.  x is
    padded by ph in H and the layer's `padding` in W; full_h is the whole
    image's height (the gates')."""
    modes = current_modes()
    if modes.int8 and quant.eligible(w.shape[1], w.shape[0]):
        return quant.conv2d_int8(x, w, bias, stride, (ph, padding), dilation)
    if modes.pack_small_cin:
        y = _packed_small_cin(x, w, stride, padding, dilation, ph, full_h)
        if y is not None:
            return _with_bias(y, bias)
    if modes.pack_out:
        y = _packed_out_conv(x, w, stride, padding, dilation, ph, full_h)
        if y is not None:
            return _with_bias(y, bias)
    return None


def _moded_conv_transpose2d(x, w, bias, stride, padding, full_h):
    """The transposed conv under the conv modes in force (int8, pack_out),
    or None for the direct one; full_h is the whole image's input
    height."""
    modes = current_modes()
    if modes.int8 and quant.eligible(w.shape[0], w.shape[1]):
        return quant.conv_transpose2d_int8(x, w, bias, stride, padding)
    if modes.pack_out:
        y = _packed_out_deconv(x, w, stride, padding, full_h)
        if y is not None:
            return _with_bias(y, bias)
    return None


# ---- convs on a slab of rows (spatial partitioning) ------------------------

def _slab_conv2d(x, w, bias, stride, padding, dilation, sp):
    """Conv2d of a slab (see the module docstring); bias None or in x's
    dtype is fused, another is added after as Conv2d adds it.  The conv
    modes run on the halo'd slab, gated on the whole image's height."""
    k, h = w.shape[2], x.shape[2]
    above = padding[0]
    below = (k - 1) * dilation[0] - above - stride[0] + 1
    if h % stride[0] or below < 0:
        raise ValueError(
            f"a k{k} s{stride[0]} p{above} d{dilation[0]} conv cannot run "
            f"on a slab of {h} rows under spatial partitioning (the slab "
            "height must be a multiple of the stride)")
    xh = halo_exchange(x, sp.group, sp.index, sp.size, above, below)
    y = _moded_conv2d(xh, w, bias, stride[0], 0, padding[1], dilation[0],
                      h * sp.size)
    if y is not None:
        return y
    fused = bias if bias is None or bias.dtype == x.dtype else None
    y = F.conv2d(xh, w, fused, stride, (0, padding[1]), dilation)
    return y if fused is bias else _with_bias(y, bias)


def _slab_conv_transpose2d(x, w, bias, stride, padding, sp):
    """ConvTranspose2d of a slab: the halo'd slab's output (at the layer's
    own padding, under the conv modes as in one process), cut to the
    stride * h rows this slab's inputs own."""
    k, s, p = w.shape[2], stride[0], padding[0]
    if k - 2 * p != s:
        raise NotImplementedError(
            f"a k{k} s{s} p{p} transposed conv does not map a slab to "
            f"{s} times its rows; spatial partitioning runs k - 2p == s")
    above, below = (k - 1 - p) // s, (p - 1 + s) // s
    xh = halo_exchange(x, sp.group, sp.index, sp.size, above, below)
    y = _moded_conv_transpose2d(xh, w, bias, s, p, x.shape[2] * sp.size)
    if y is None:
        fused = bias if bias is None or bias.dtype == x.dtype else None
        y = F.conv_transpose2d(xh, w, fused, stride, padding)
        y = y if fused is bias else _with_bias(y, bias)
    return y.narrow(2, above * s, x.shape[2] * s)


# ---- the hand-written f32 convolution (csrc/conv2d.cu) ---------------------
#
# On a CUDA f32 input, with no conv mode and no spatial partition in force,
# two convolutions leave cuDNN for ops/conv_cuda.py's kernel: the forward of
# every kernel-4 Conv2d, and the input gradient of every ConvTranspose2d
# (the plain conv of the output gradient by the layer's own weight).  The
# other gradients, every kernel-3 Conv2d and every transposed forward stay
# on cuDNN.  conv_cuda.takes, a rule over the GEMM's shape measured on the
# card, keeps cuDNN where it is the faster; in a traced graph, whose batch
# may be symbolic, the op applies the rule itself at run time.  Each launch
# opens the span dip.hand.direct2d.


@torch.library.custom_op("deepinpainting::conv2d_f32", mutates_args=(),
                         device_types="cpu")
def conv2d_f32(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
               stride: int, padding: int, dilation: int) -> torch.Tensor:
    """F.conv2d as the custom op `deepinpainting::conv2d_f32`: on CUDA
    tensors the hand-written kernel (ops/conv_cuda.py) where
    conv_cuda.takes the shape and cuDNN elsewhere, F.conv2d itself on CPU
    ones.  A new tensor."""
    return F.conv2d(x, w, bias, stride, padding, dilation)


@conv2d_f32.register_kernel("cuda")
def _conv2d_f32_cuda(x, w, bias, stride, padding, dilation):
    # a traced graph (torch.export, a symbolic batch) routes every call it
    # might take here, and the rule picks by the batch the call brings
    ks = w.shape[2]
    m = (x.shape[0] * conv_cuda.out_size(x.shape[2], ks, stride, padding,
                                         dilation)
         * conv_cuda.out_size(x.shape[3], ks, stride, padding, dilation))
    if conv_cuda.takes(m, w.shape[0], w.shape[1] * ks * ks, stride,
                       dilation):
        return conv_cuda.conv2d_f32_cuda(x, w, bias, stride, padding,
                                         dilation)
    return F.conv2d(x, w, bias, stride, padding, dilation)


@conv2d_f32.register_fake
def _conv2d_f32_fake(x, w, bias, stride, padding, dilation):
    ks = w.shape[2]
    return x.new_empty((
        x.shape[0], w.shape[0],
        conv_cuda.out_size(x.shape[2], ks, stride, padding, dilation),
        conv_cuda.out_size(x.shape[3], ks, stride, padding, dilation)))


def _hand_conv(x, w, bias, stride, padding, dilation):
    """One launch of the kernel.  Run eagerly on the card it calls the
    kernel's wrapper itself: going through the custom op's dispatcher
    costs about 20 µs of host time a call, as much as the rest of the
    launch (~30 µs on an H100's host); a trace (torch.export) and CPU
    tensors take the op."""
    with span("dip.hand.direct2d"):
        x, w = x.contiguous(), w.contiguous()
        if x.is_cuda and not torch.compiler.is_compiling():
            return conv_cuda.conv2d_f32_cuda(x, w, bias, stride, padding,
                                             dilation)
        return conv2d_f32(x, w, bias, stride, padding, dilation)


class HandConv2d(torch.autograd.Function):
    """Conv2d whose forward is the hand-written kernel; its input and weight
    gradients are aten's (cuDNN on the card)."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, padding, dilation, bias is not None
        return _hand_conv(x, w, bias, stride, padding, dilation)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        s, p, d, has_bias = ctx.geometry
        need = ctx.needs_input_grad
        gx, gw, gb = torch.ops.aten.convolution_backward(
            gy, x, w, [w.shape[0]] if has_bias else None, [s, s], [p, p],
            [d, d], False, [0, 0], 1,
            [need[0], need[1], has_bias and need[2]])
        return gx, gw, gb, None, None, None


class HandConvTranspose2d(torch.autograd.Function):
    """ConvTranspose2d (output_padding 0, dilation 1) on aten (cuDNN on the
    card) whose input gradient is the hand-written kernel: conv2d(gy, w,
    stride, padding) with the layer's own weight [Cin, Cout, k, k]."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, padding, bias is not None
        return F.conv_transpose2d(x, w, bias, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        s, p, has_bias = ctx.geometry
        need = ctx.needs_input_grad
        gx = _hand_conv(gy, w, None, s, p, 1) if need[0] else None
        gw = gb = None
        if need[1] or (has_bias and need[2]):
            _, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[1]] if has_bias else None, [s, s], [p, p],
                [1, 1], True, [0, 0], 1,
                [False, need[1], has_bias and need[2]])
        return gx, gw, gb, None, None


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _hand_routes(layer: nn.Module, x: torch.Tensor) -> bool:
    """Whether `layer` (its weight and geometry) on x is a call the
    hand-written kernel takes: an f32 input on the card, no conv mode and
    no spatial partition in force, square geometry, groups 1, and a GEMM
    shape that conv_cuda.takes (under a trace, whose batch may be
    symbolic, any kernel-4 Conv2d: the op applies the rule at run
    time)."""
    if not (_on_card(x) and x.dtype == torch.float32
            and layer.weight.dtype == torch.float32
            and current_modes() == ConvModes() and current_spatial() is None
            and layer.groups == 1 and layer.padding_mode == "zeros"
            and len(set(layer.stride)) == 1 and len(set(layer.padding)) == 1
            and len(set(layer.dilation)) == 1):
        return False
    bsz, _, h, wd = x.shape
    ks, s, p, d = (layer.kernel_size[0], layer.stride[0], layer.padding[0],
                   layer.dilation[0])
    w = layer.weight
    if isinstance(layer, nn.ConvTranspose2d):
        # the input gradient: conv2d(gy, w) back onto x's pixels
        return (ks in (3, 4) and d == 1 and layer.kernel_size[1] == ks
                and not any(layer.output_padding)
                and torch.is_grad_enabled() and x.requires_grad
                and conv_cuda.takes(bsz * h * wd, w.shape[0],
                                    w.shape[1] * ks * ks, s, 1))
    if layer.kernel_size != (4, 4):
        return False
    if torch.compiler.is_compiling():
        return True
    ho = conv_cuda.out_size(h, ks, s, p, d)
    wo = conv_cuda.out_size(wd, ks, s, p, d)
    return conv_cuda.takes(bsz * ho * wo, w.shape[0], w.shape[1] * ks * ks,
                           s, d)


def _hand_conv2d(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    args = (x, layer.weight, layer.bias, layer.stride[0], layer.padding[0],
            layer.dilation[0])
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args[:3]):
        return HandConv2d.apply(*args)
    return _hand_conv(*args)


def _weight_as(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conv's weight in its input's dtype: the f32 parameter itself, or
    its per-call cast (the bf16 boundary)."""
    if w.dtype == dtype:
        return w
    with span("dip.bf16.weight_cast"):
        return w.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype (see the module
    docstring) under the conv modes in force; on an f32 input with no mode
    it is nn.Conv2d unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_as(self.weight, x.dtype)
        sp = current_spatial()
        if sp is not None:
            return _slab_conv2d(x, w, self.bias, self.stride, self.padding,
                                self.dilation, sp)
        p = self.padding[0]
        y = _moded_conv2d(x, w, self.bias, self.stride[0], p, p,
                          self.dilation[0], x.shape[2])
        if y is not None:
            return y
        if _hand_routes(self, x):
            return _hand_conv2d(self, x)
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return _with_bias(self._conv_forward(x, w, None), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (output_padding 0) that computes in its input's
    dtype under the conv modes in force, as Conv2d does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_as(self.weight, x.dtype)
        sp = current_spatial()
        if sp is not None:
            return _slab_conv_transpose2d(x, w, self.bias, self.stride,
                                          self.padding, sp)
        y = _moded_conv_transpose2d(x, w, self.bias, self.stride[0],
                                    self.padding[0], x.shape[2])
        if y is not None:
            return y
        if _hand_routes(self, x):
            return HandConvTranspose2d.apply(x, self.weight, self.bias,
                                             self.stride[0], self.padding[0])
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.conv_transpose2d(x, w, None, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _with_bias(y, self.bias)


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d at its defaults (eps 1e-5, momentum 0.1), which is
    what the JAX package's TorchBatchNorm reproduces: train mode normalises
    with the biased batch variance over (N, H, W) and tracks the unbiased
    one, eval mode uses the running statistics.

    On an input in another dtype than f32 the statistics and the
    normalisation run in f32, the result is cast back, and the scale and
    offset apply in the input's dtype (TorchBatchNorm's arithmetic; a bare
    nn.BatchNorm2d applies them in f32).  Inside frozen_running_stats a
    train-mode forward normalises by its batch as usual but leaves the
    running statistics where they were.

    Inside a process group (parallel/collectives.py::use_group) train mode
    takes the global batch's moments over (N, H, W), as the JAX package's
    TorchBatchNorm does under SPMD: the per-channel sum and count, then
    the per-channel sum of squared deviations from the global mean, each
    all-reduced with autograd (two reductions, as the JAX layer's
    mean((x - mean)^2): a one-pass sum of squares loses digits to
    cancellation in f32).  The biased variance normalises, and the running
    variance takes the unbiased one with the global count.  In a sharded
    region (spatial partitioning) the moments are those of the whole grid
    of ranks, every row of every image of the global batch."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = batch_group()
        if self.training and group is not None:
            return self._global_forward(x, group)
        mean, var = self.running_mean, self.running_var
        if self.training and self.frozen:
            # copies take the update; passing none would change what the
            # forward saves for the backward, which checkpoint compares
            mean, var = mean.clone(), var.clone()
        elif self.training:
            self.num_batches_tracked.add_(1)
        if x.dtype == self.weight.dtype:
            return F.batch_norm(x, mean, var, self.weight, self.bias,
                                self.training, self.momentum, self.eps)
        y = F.batch_norm(x.to(self.weight.dtype), mean, var, None, None,
                         self.training, self.momentum, self.eps).to(x.dtype)
        return (y * _channels(self.weight, x.dtype)
                + _channels(self.bias, x.dtype))

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        xf = x.to(torch.float32)
        c = xf.shape[1]
        local = torch.cat([xf.sum(dim=(0, 2, 3)),
                           xf.new_full((1,), xf.numel() // c)])
        sums = all_reduce_sum(local, group)
        n = sums[c]
        mean = sums[:c] / n
        centred = xf - mean[:, None, None]
        var = all_reduce_sum(centred.square().sum(dim=(0, 2, 3)), group) / n
        if not self.frozen:
            self.num_batches_tracked.add_(1)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / (n - 1).clamp(min=1)
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        y = centred * torch.rsqrt(var + self.eps)[:, None, None]
        if x.dtype == self.weight.dtype:
            return y * _channels(self.weight, y.dtype) + _channels(
                self.bias, y.dtype)
        y = y.to(x.dtype)
        return (y * _channels(self.weight, x.dtype)
                + _channels(self.bias, x.dtype))


@contextlib.contextmanager
def frozen_running_stats(*modules: nn.Module):
    """Within the block, the BatchNorm layers of `modules` do not move
    their running statistics: for forwards that repeat one whose update was
    already taken (a rematerialised block's recompute, the G phase of a
    gradient-accumulated step).  Nests; each layer gets its flag back."""
    layers = [m for mod in modules for m in mod.modules()
              if isinstance(m, BatchNorm)]
    before = [m.frozen for m in layers]
    for m in layers:
        m.frozen = True
    try:
        yield
    finally:
        for m, flag in zip(layers, before):
            m.frozen = flag


def make_norm(norm: str, channels: int) -> nn.Module:
    """Norm-layer factory (Config.norm): 'instance' is InstanceNorm above,
    'batch' is BatchNorm."""
    if norm == "instance":
        return InstanceNorm(channels)
    if norm == "batch":
        return BatchNorm(channels)
    raise NotImplementedError(
        f"normalization layer [{norm}] is not found (supported: "
        f"{', '.join(NORMS)})")


class Dropout(nn.Module):
    """Inverted dropout, active in train mode only: each element is kept
    with probability 1 - p and scaled by 1 / (1 - p).  The keep mask comes
    from `generator`, a torch.Generator on x's device (nn.Dropout takes
    none); None draws from that device's default generator.  On a slab
    (spatial partitioning) it draws the whole image's mask, as one process
    draws it, and keeps its rows."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        sp = current_spatial()
        shape = list(x.shape)
        if sp is not None:
            shape[2] *= sp.size
        keep = own_rows(torch.rand(shape, generator=generator,
                                   device=x.device, dtype=torch.float32)
                        >= self.p)
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.p))


def bilinear_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(method='bilinear') on NCHW: half-pixel centres
    (align_corners=False) with a widened triangle kernel when shrinking
    (antialias).  Used only where a skip connection's size mismatches.  On
    a slab (spatial partitioning) `height` is the target slab's: the
    resize runs on the gathered image and keeps this rank's rows."""
    sp = current_spatial()
    if sp is not None:
        full = full_rows(x)
        with replicated():
            y = bilinear_resize(full, height * sp.size, width)
        return own_rows(y)
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def init_weight_(weight: torch.Tensor, init_type: str, gain: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Fill a conv / conv-transpose weight in place (torch layout).

    torch's fan convention holds for both layouts: fan_in = size(1)*kh*kw,
    fan_out = size(0)*kh*kw.
      * normal:     N(0, gain)
      * xavier:     N(0, gain*sqrt(2/(fan_in+fan_out)))
      * kaiming:    N(0, sqrt(2/fan_in))
      * orthogonal: rows of the [size(0), rest] matrix orthonormal, * gain
    """
    shape = weight.shape
    rf = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * rf, shape[0] * rf
    draw = lambda s: torch.randn(s, generator=generator, dtype=torch.float32)
    if init_type == "normal":
        w = gain * draw(shape)
    elif init_type == "xavier":
        w = gain * math.sqrt(2.0 / (fan_in + fan_out)) * draw(shape)
    elif init_type == "kaiming":
        w = math.sqrt(2.0 / fan_in) * draw(shape)
    elif init_type == "orthogonal":
        rows, cols = shape[0], weight.numel() // shape[0]
        big, small = max(rows, cols), min(rows, cols)
        q, r = torch.linalg.qr(draw((big, small)))
        q = q * torch.sign(torch.diagonal(r))   # Haar-uniform sign fix
        m = q.T if rows < cols else q           # [rows, cols]
        w = gain * m.reshape(shape)
    else:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    with torch.no_grad():
        weight.copy_(w)
    return weight


def he_normal_(weight: torch.Tensor, generator: torch.Generator
               ) -> torch.Tensor:
    """flax he_normal: truncated normal at +-2 std, variance 2/fan_in."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    w = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w)
    return weight
