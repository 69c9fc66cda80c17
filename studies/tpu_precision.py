"""The TPU's default matmul precision, emulated on the port for a study.

On a TPU, an f32 conv or dot that passes no `precision` runs one bf16
pass: both operands are rounded to bf16, the products (exact in f32, a
bf16 x bf16 product has 16 significant bits) are summed in f32.  The JAX
package passes no `precision` to any conv or product, so its recorded
"f32" runs trained that way.  `install()` makes the port do the same, in
this process:

  * torch.nn.functional.conv2d / conv_transpose2d (every Conv2d and
    ConvTranspose2d of G, P, D, F and VGG goes through one of them) take
    bf16-rounded input and weight in the forward, and the backward's two
    convolutions take the bf16-rounded output gradient with them; the
    bias and its gradient stay f32, as an add is not a matmul;
  * the attention's three products (ops/attention.py: the scores of
    `prep`, the decode kbar @ P and the backward's g @ K) take rounded
    operands, forward and backward alike.

Only f32 operands are rounded (a bf16 compute path is left as it is).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

_ORIGINAL = {}


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even) and back to t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        xr, wr = bf16(x), bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, dilation, transposed, output_padding,
                    groups)
        ctx.has_bias = b is not None
        return torch.ops.aten.convolution(xr, wr, b, *ctx.conf)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            bf16(g), xr, wr, None, *ctx.conf, [need_x, need_w, False])
        gb = g.sum(dim=(0, 2, 3)) if ctx.has_bias else None
        return gx, gw, gb, None, None, None, None, None, None


def _conf(stride, padding, dilation, output_padding=0):
    return ([*_pair(stride)], [*_pair(padding)], [*_pair(dilation)],
            [*_pair(output_padding)])


def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if x.dtype != torch.float32 or isinstance(padding, str):
        return _ORIGINAL["conv2d"](x, w, bias, stride, padding, dilation,
                                   groups)
    s, p, d, op = _conf(stride, padding, dilation)
    return _RoundedConv.apply(x, w, bias, s, p, d, False, op, groups)


def conv_transpose2d(x, w, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1):
    if x.dtype != torch.float32:
        return _ORIGINAL["conv_transpose2d"](x, w, bias, stride, padding,
                                             output_padding, groups,
                                             dilation)
    s, p, d, op = _conf(stride, padding, dilation, output_padding)
    return _RoundedConv.apply(x, w, bias, s, p, d, True, op, groups)


class _RoundedBmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = bf16(a), bf16(b)
        ctx.save_for_backward(ar, br)
        return torch.bmm(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = bf16(g)
        return gr @ br.transpose(1, 2), ar.transpose(1, 2) @ gr


def bmm(a, b):
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return torch.bmm(a, b)
    return _RoundedBmm.apply(a, b)


class _TorchWithRoundedBmm:
    """torch, but for bmm: the name `torch` inside ops/attention.py."""

    bmm = staticmethod(bmm)

    def __getattr__(self, name):
        return getattr(torch, name)


def install() -> None:
    """Round the operands of every conv and of the attention's products,
    in this process, from now on."""
    from deepinpainting_torch.ops import attention as A
    if _ORIGINAL:
        return
    _ORIGINAL.update(conv2d=F.conv2d, conv_transpose2d=F.conv_transpose2d)
    F.conv2d = conv2d
    F.conv_transpose2d = conv_transpose2d
    A.torch = _TorchWithRoundedBmm()
