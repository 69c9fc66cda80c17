"""Dynamic int8 post-training quantisation of the convolutions (counterpart
of deepinpainting_tpu/ops/quant.py), inference only.

The scheme is the JAX package's, number for number:

  * weights:     per output channel, symmetric; the scale is
                 max|w| / 127 + 1e-12 over the channel, from the weight in
                 the activation dtype (under bf16 the bf16-rounded weight)
  * activations: per tensor, symmetric: max|x| / 127 + 1e-12 over the
                 whole tensor that the JAX package's one-device program
                 quantises there, q = clip(round(x / scale), -127, 127),
                 round half to even.  Where a process holds part of that
                 tensor (parallel/collectives.py::batch_group: its rows of
                 the global batch under data parallelism, and its slab of
                 their rows in a sharded region) the maximum is all-reduced
                 over the ranks that hold the rest, so the scale does not
                 depend on how the batch or the image is split
  * accumulate:  int32; then int32 -> f32, times (sx * sw), cast to the
                 activation dtype, and the bias added in that dtype
  * eligibility: convs with min(Cin, Cout) >= MIN_QUANT_CHANNELS only

The product runs as a matrix product s8 x s8 -> s32 (`torch._int_mm`,
cuBLASLt on the card): the padded input's windows are copied once into a
row-major [B*Ho*Wo, Cin*kh*kw] int8 matrix (an im2col through tensor
views: F.unfold refuses int8) and multiplied by the weight as [K, Cout].
A transposed conv is the conv of its flipped kernel over the input
dilated with zeros (the JAX package's lhs dilation).  On the card
`_int_mm` needs more than 16 rows and K and N multiples of 8 (netP's and
netG's innermost level is 1x1 at 256 px, so M = B); every call pads M (by
24 rows), K and N, always, so the CPU runs the padding too.  Zero weight
rows and columns make the padding exact, and the rows past M are dropped.

Integer sums do not depend on their order, so `conv2d_int32` and
`conv_transpose2d_int32` equal their plain versions (`..._reference`: an
f64 convolution over the int8 values, exact since |sum| <= 127^2 * kh *
kw * Cin << 2^53) bit for bit.  The plain versions serve tests and the
card's checks; no entry point calls them.  For the same reason a conv on
a slab of rows (spatial partitioning: the halo'd slab, no H padding of
its own, ops/convs.py) gives, with the same scale, the whole tensor's
int32 sums of its rows bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_max, batch_group

#: convs narrower than this on either side stay in the activation dtype
MIN_QUANT_CHANNELS = 16


def eligible(cin: int, cout: int) -> bool:
    """True when both channel counts reach the quantisation floor."""
    return min(cin, cout) >= MIN_QUANT_CHANNELS


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 + 1e-12 in f32, the division an IEEE one on every
    device: CUDA turns a division by a Python number into a multiplication
    by its reciprocal, which can differ in the last bit."""
    return amax / torch.full_like(amax, 127.0) + 1e-12


def quantize_activation(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale) with x ~= q * scale; scale is
    a 0-dim f32 tensor, from the maximum over every rank of batch_group()
    (one all-reduce of one f32; a local maximum in one process)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax()
    group = batch_group()
    if group is not None:
        amax = all_reduce_max(amax, group)
    scale = _scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, transposed: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a conv weight [Cout, Cin, kh,
    kw], or with `transposed` a ConvTranspose2d weight [Cin, Cout, kh, kw]:
    (q in w's layout, scale [Cout] f32)."""
    wf = w.to(torch.float32)
    out_dim = 1 if transposed else 0
    dims = tuple(d for d in range(4) if d != out_dim)
    scale = _scale(wf.abs().amax(dim=dims))
    shape = [1, 1, 1, 1]
    shape[out_dim] = -1
    q = torch.clamp(torch.round(wf / scale.view(shape)), -127, 127
                    ).to(torch.int8)
    return q, scale


def _round_up(n, m: int):
    return (n + m - 1) // m * m


Padding = Union[int, Tuple[int, int]]


def _pads(padding: Padding) -> Tuple[int, int]:
    """(ph, pw) of an int or an (H, W) pair, as F.conv2d reads them."""
    return (padding, padding) if isinstance(padding, int) else padding


def conv2d_int32(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                 padding: Padding = 0, dilation: int = 1) -> torch.Tensor:
    """The int32 sums of an int8 conv: xq [B, Cin, H, W], wq [Cout, Cin,
    kh, kw] (int8) -> [B, Cout, Ho, Wo] int32 (a view in NHWC memory
    order).  `padding` is one int for both axes or (ph, pw): a slab of
    rows takes (0, p), its halo being its H padding."""
    b, cin = xq.shape[:2]
    cout, _, kh, kw = wq.shape
    ph, pw = _pads(padding)
    xp = F.pad(xq, (pw, pw, ph, ph))
    span_h, span_w = dilation * (kh - 1) + 1, dilation * (kw - 1) + 1
    win = xp.unfold(2, span_h, stride).unfold(3, span_w, stride)
    win = win[..., ::dilation, ::dilation]        # [B, Cin, Ho, Wo, kh, kw]
    ho, wo = win.shape[2:4]
    m, k = b * ho * wo, cin * kh * kw
    # M + 24 rows: more than 16 at any batch, an 8-aligned M stays aligned,
    # and a symbolic batch (export) needs no guard on it
    kp, n_p = _round_up(k, 8), _round_up(cout, 8)
    a = torch.empty((m + 24, kp), dtype=torch.int8, device=xq.device)
    a[:m, :k].view(b, ho, wo, cin, kh, kw).copy_(
        win.permute(0, 2, 3, 1, 4, 5))
    a[m:].zero_()
    a[:m, k:].zero_()
    w = F.pad(wq.reshape(cout, k), (0, kp - k, 0, n_p - cout))   # [Np, Kp]
    acc = torch._int_mm(a, w.t())                                # [Mp, Np]
    return acc[:m, :cout].view(b, ho, wo, cout).permute(0, 3, 1, 2)


def conv2d_int32_reference(xq: torch.Tensor, wq: torch.Tensor,
                           stride: int = 1, padding: Padding = 0,
                           dilation: int = 1) -> torch.Tensor:
    """The plain version of conv2d_int32: an f64 convolution over the int8
    values, exact, rounded back to int32."""
    y = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), None, stride,
                 padding, dilation)
    return torch.round(y).to(torch.int32)


def conv_transpose2d_int32(xq: torch.Tensor, wq: torch.Tensor,
                           stride: int = 1, padding: int = 0
                           ) -> torch.Tensor:
    """The int32 sums of an int8 ConvTranspose2d (output_padding 0): xq
    [B, Cin, H, W], wq [Cin, Cout, kh, kw] -> [B, Cout, Ho, Wo] int32.  It
    is the stride-1 conv of the flipped kernel over xq dilated by
    `stride`, padded by k - 1 - padding."""
    if stride > 1:
        b, c, h, w = xq.shape
        z = xq.new_zeros((b, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
        z[:, :, ::stride, ::stride] = xq
        xq = z
    return conv2d_int32(xq, wq.flip(2, 3).transpose(0, 1), 1,
                        wq.shape[2] - 1 - padding)


def conv_transpose2d_int32_reference(xq: torch.Tensor, wq: torch.Tensor,
                                     stride: int = 1, padding: int = 0
                                     ) -> torch.Tensor:
    """The plain version of conv_transpose2d_int32 (f64, exact)."""
    y = F.conv_transpose2d(xq.to(torch.float64), wq.to(torch.float64),
                           None, stride, padding)
    return torch.round(y).to(torch.int32)


def _dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                dtype: torch.dtype, bias: Optional[torch.Tensor]
                ) -> torch.Tensor:
    y = (acc.to(torch.float32) * (sx * sw)[:, None, None]).to(dtype)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


def conv2d_int8(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int = 1,
                padding: Padding = 0, dilation: int = 1) -> torch.Tensor:
    """Conv2d on the int8 path, in x's dtype: x [B, Cin, H, W], weight
    [Cout, Cin, kh, kw] already in x's dtype."""
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(weight)
    return _dequantize(conv2d_int32(xq, wq, stride, padding, dilation),
                       sx, sw, x.dtype, bias)


def conv_transpose2d_int8(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], stride: int = 1,
                          padding: int = 0) -> torch.Tensor:
    """ConvTranspose2d (output_padding 0) on the int8 path, in x's dtype:
    weight [Cin, Cout, kh, kw] already in x's dtype.  The JAX package
    quantises the flipped kernel; a flip changes neither a channel's max
    nor any rounding, so the weight quantises as it lies."""
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(weight, transposed=True)
    return _dequantize(conv_transpose2d_int32(xq, wq, stride, padding),
                       sx, sw, x.dtype, bias)
