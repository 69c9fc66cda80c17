"""Wrappers of the hand-written CUDA attention kernels:

  * `scan_stream_cuda` (csrc/scan_stream.cu), the coherence scan, which
    replaces deepinpainting_tpu/ops/attention_pallas.py::_scan_stream_kernel;
  * `kbar_build_cuda` (csrc/kbar_build.cu), the attention-matrix kernel of
    the training forward, which replaces `_kbar_kernel` of the same file.

Each takes CUDA tensors only and launches its kernel or raises.  They are
the CUDA implementations of the custom ops `deepinpainting::scan_stream`
and `deepinpainting::kbar_build` (ops/attention.py), whose CPU
implementations are the plain versions (scan_stream_reference,
kbar_build_reference): the ops choose by the tensors' device.  The
kernels are built with nvcc at first use (_build.py) and bound with
ctypes.

`launches` (scan) and `kbar_launches` count the kernel launches made
through each wrapper, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

launches = 0
kbar_launches = 0

_fns = {}


def _kernel(name: str, argtypes):
    """The C launcher `<name>_f32` of csrc/<name>.cu, built on first use."""
    if name not in _fns:
        fn = getattr(_build.load(name), f"{name}_f32")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


_SCAN_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_KBAR_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def check_inputs(flag: torch.Tensor, vmax: torch.Tensor, pn: torch.Tensor,
                 known: torch.Tensor) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if pn.dim() != 3:
        raise ValueError(f"pn must be [B, N, C], got {tuple(pn.shape)}")
    bsz, n, c = pn.shape
    if tuple(known.shape) != (bsz, n, c):
        raise ValueError(f"known {tuple(known.shape)} != pn {tuple(pn.shape)}")
    for name, t in (("flag", flag), ("vmax", vmax)):
        if tuple(t.shape) != (bsz, n):
            raise ValueError(f"{name} must be [{bsz}, {n}], "
                             f"got {tuple(t.shape)}")
    for name, t in (("flag", flag), ("vmax", vmax), ("pn", pn),
                    ("known", known)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != pn.device:
            raise ValueError(f"{name} on {t.device}, pn on {pn.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if c % 4 != 0 or not 4 <= c <= 1024:
        raise ValueError(f"C must be a multiple of 4 in [4, 1024], got {c}")


def scan_stream_cuda(flag: torch.Tensor, vmax: torch.Tensor,
                     pn: torch.Tensor, known: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the scan kernel on the current stream.

    flag/vmax: [B, N] f32; pn/known: [B, N, C] f32, contiguous, on one card.
    Returns (out [B,N,C], a [B,N], b [B,N]).
    """
    global launches
    check_inputs(flag, vmax, pn, known)
    bsz, n, c = pn.shape
    out = torch.empty_like(known)
    a = torch.empty_like(vmax)
    b = torch.empty_like(vmax)
    if bsz == 0 or n == 0:
        return out, a, b
    fn = _kernel("scan_stream", _SCAN_ARGS)
    stream = torch.cuda.current_stream(pn.device).cuda_stream
    rc = fn(pn.data_ptr(), known.data_ptr(), flag.data_ptr(),
            vmax.data_ptr(), out.data_ptr(), a.data_ptr(), b.data_ptr(),
            bsz, n, c, pn.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"scan_stream kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, a, b


def check_kbar_inputs(flag: torch.Tensor, ind: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> None:
    """Raise ValueError for anything the kbar kernel does not take."""
    if flag.dim() != 2:
        raise ValueError(f"flag must be [B, N], got {tuple(flag.shape)}")
    bsz, n = flag.shape
    named = (("flag", flag), ("ind", ind), ("a", a), ("b", b))
    for name, t in named:
        if tuple(t.shape) != (bsz, n):
            raise ValueError(f"{name} must be [{bsz}, {n}], "
                             f"got {tuple(t.shape)}")
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != flag.device:
            raise ValueError(f"{name} on {t.device}, flag on {flag.device}")
        want = ((torch.int32, torch.int64) if name == "ind"
                else (torch.float32,))
        if t.dtype not in want:
            raise ValueError(f"{name} must be one of {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bsz > 65535:
        raise ValueError(f"B must be at most 65535, got {bsz}")


def kbar_build_cuda(flag: torch.Tensor, ind: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Launch the kbar kernel on the current stream.

    flag/a/b: [B, N] f32; ind: [B, N] int32 or int64 (a value outside
    [0, N) matches no column and contributes nothing); all contiguous, on
    one card.  Returns kbar [B, N, N] f32.
    """
    global kbar_launches
    check_kbar_inputs(flag, ind, a, b)
    bsz, n = flag.shape
    kbar = torch.empty((bsz, n, n), dtype=torch.float32, device=flag.device)
    if bsz == 0 or n == 0:
        return kbar
    fn = _kernel("kbar_build", _KBAR_ARGS)
    stream = torch.cuda.current_stream(flag.device).cuda_stream
    rc = fn(flag.data_ptr(), ind.data_ptr(), ind.element_size(), a.data_ptr(),
            b.data_ptr(), kbar.data_ptr(), bsz, n, flag.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"kbar_build kernel launch failed: CUDA error {rc}")
    kbar_launches += 1
    return kbar
