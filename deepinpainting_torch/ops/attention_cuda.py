"""Wrapper of the hand-written CUDA coherence-scan kernel
(csrc/scan_stream.cu), which replaces the Pallas TPU kernel
deepinpainting_tpu/ops/attention_pallas.py::_scan_stream_kernel.

`scan_stream_cuda` takes CUDA tensors only and launches the kernel or
raises; the choice between it and the plain version
(ops/attention.py::scan_stream_reference) is made by the tensors' device in
ops/attention.py::scan_stream.  The kernel is built with nvcc at first use
(_build.py) and bound with ctypes.

`launches` counts the kernel launches made through this wrapper, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("scan_stream")
        fn = lib.scan_stream_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    fn = _kernel()
    stream = torch.cuda.current_stream(pn.device).cuda_stream
    rc = fn(pn.data_ptr(), known.data_ptr(), flag.data_ptr(),
            vmax.data_ptr(), out.data_ptr(), a.data_ptr(), b.data_ptr(),
            bsz, n, c, pn.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"scan_stream kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, a, b
