"""Wrapper of the hand-written f32 convolution, csrc/conv2d.cu.

`conv2d_f32_cuda(x, w, bias, stride, padding, dilation)` is F.conv2d for a
CUDA f32 NCHW input and a square kernel of 3 or 4 (groups 1, zero padding):
an implicit GEMM on the CUDA cores with f32 operands and accumulation in a
fixed order (see the source).  It is the CUDA implementation of the custom
op `deepinpainting::conv2d_f32` (ops/convs.py), whose CPU implementation is
F.conv2d; it launches its kernels or raises.  `plan(m, n, k)` picks the
tile and the split of the depth from the GEMM's shape; `launches` counts
the launches made through the wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from .. import _build

launches = 0

SMS = 132                 # streaming multiprocessors of an H100
BK = 8                    # depth of one step of the kernel
MIN_SPLIT_DEPTH = 256     # a split slice keeps at least this much depth

_fn = None
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p])


class Plan(NamedTuple):
    """A launch's tile (bm x bn of the GEMM) and its split of the depth
    into `splits` slices of `k_split` each."""
    bm: int
    bn: int
    splits: int
    k_split: int


TILES = ((256, 128), (128, 128), (128, 64), (64, 64))   # (bm, bn) built


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int) -> Plan:
    """The launch for a GEMM of m rows (output pixels), n columns (output
    channels) and depth k (input channels times taps), as the sweep of
    every tile and split at the routed shapes chose (studies/
    conv_shapes.py --sweep, PERF.md): 256 x 128 tiles (one block an SM)
    for the large products, 128 x 128, 128 x 64 or 64 x 64 (two blocks an
    SM) for narrow, short, shallow or small ones; then the depth split in
    powers of two while the blocks fit one wave and a slice keeps
    MIN_SPLIT_DEPTH."""
    if n <= 64:
        bm, bn = (64, 64) if m <= 64 else (128, 64)
    elif m <= 64:
        bm, bn = 64, 64
    elif k < MIN_SPLIT_DEPTH or m <= 128 or m * n <= 2 ** 19:
        bm, bn = 128, 128
    else:
        bm, bn = 256, 128
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    wave = SMS if (bm, bn) == (256, 128) else 2 * SMS
    splits = 1
    while tiles * splits * 2 <= wave and k // (2 * splits) >= MIN_SPLIT_DEPTH:
        splits *= 2
    k_split = math.ceil(math.ceil(k / splits) / BK) * BK
    return Plan(bm, bn, math.ceil(k / k_split), k_split)


@functools.lru_cache(maxsize=None)
def takes(m: int, n: int, k: int, stride: int, dilation: int) -> bool:
    """Whether the kernel takes a convolution whose GEMM has m rows, n
    columns and depth k (else cuDNN keeps it), by what the card showed at
    every routed shape (PERF.md): cuDNN's f32 implicit GEMM runs the large
    dense stride-2 products at 58-64% of the f32 peak, as fast as this
    kernel or faster, but takes a slower algorithm for stride-1 and dilated
    convs of deep K up to 2**23 outputs, fills the card poorly up to 2**21
    outputs, and does little with a depth under 256.  A single output
    channel (netD's head) stays on cuDNN."""
    if n < 32:
        return False
    return (k < MIN_SPLIT_DEPTH or m * n <= 2 ** 21
            or (k >= 2304 and m * n <= 2 ** 23
                and (stride == 1 or dilation > 1)))


def out_size(size: int, k: int, stride: int, padding: int,
             dilation: int) -> int:
    """Output length of a convolution along one axis."""
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def check_inputs(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x and w must be 4-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} does not take x's "
                         f"{x.shape[1]} channels")
    if w.shape[2] != w.shape[3] or w.shape[2] not in (3, 4):
        raise ValueError(f"the kernel must be 3x3 or 4x4, got "
                         f"{tuple(w.shape[2:])}")
    named = [("x", x), ("w", w)] + ([("bias", bias)] if bias is not None
                                    else [])
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"bias must be [{w.shape[0]}], "
                         f"got {tuple(bias.shape)}")


def conv2d_f32_cuda(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: int, padding: int,
                    dilation: int) -> torch.Tensor:
    """Launch the convolution on the current stream: F.conv2d(x, w, bias,
    stride, padding, dilation) for x [B, C, H, W], w [N, C, k, k] (k 3 or
    4), bias [N] or None, all f32 contiguous on one card.  Returns y
    [B, N, Ho, Wo]."""
    check_inputs(x, w, bias)
    return _launch(x, w, bias, stride, padding, dilation, None)


def _launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            stride: int, padding: int, dilation: int,
            p: Optional[Plan]) -> torch.Tensor:
    """The launch behind conv2d_f32_cuda on checked inputs, with the plan
    p, or plan()'s where p is None (studies/conv_shapes.py --sweep passes
    each tile and split it times)."""
    global launches, _fn
    if p is not None and (p.bm, p.bn) not in TILES:
        raise ValueError(f"no {p.bm}x{p.bn} tile; built: {TILES}")
    bsz, c, h, wd = x.shape
    n, ks = w.shape[0], w.shape[2]
    ho = out_size(h, ks, stride, padding, dilation)
    wo = out_size(wd, ks, stride, padding, dilation)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"no output: a {ks}x{ks} s{stride} p{padding} "
                         f"d{dilation} conv of a {h}x{wd} input")
    y = torch.empty((bsz, n, ho, wo), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    if max(x.numel(), y.numel()) >= 2 ** 31:
        raise ValueError("x and y must each hold under 2**31 elements")
    p = p or plan(bsz * ho * wo, n, c * ks * ks)
    part = (torch.empty((p.splits,) + tuple(y.shape), dtype=torch.float32,
                        device=x.device) if p.splits > 1 else None)
    if _fn is None:
        fn = _build.load("conv2d").conv2d_f32
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
        _fn = fn
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             None if part is None else part.data_ptr(),
             bsz, c, h, wd, n, ho, wo, ks, stride, padding, dilation,
             p.bm, p.bn, p.splits, p.k_split, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"conv2d kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
