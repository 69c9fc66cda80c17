"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain `extern "C"` launcher and compiles on
its own into `build/kernels/lib<name>-<hash>.so` beside the package (the
hash covers the source and the flags, so an edited source rebuilds).  The
build happens at first use, never at import: importing the port needs no
CUDA toolkit.  `build()` starts one nvcc per source, all at once, and waits
for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("scan_stream", "kbar_build", "conv2d")

# No --use_fast_math: the scan's divisions must stay IEEE, and neither
# attention kernel's multiply-add steps may be contracted (the
# convolution's FFMA are written out).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}     # nvcc's output (ptxas -v) per kernel


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel not built yet, in parallel.  Raises
    RuntimeError with nvcc's output if one fails."""
    names = list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library for `name`.  The first load builds every kernel
    of KERNELS not built yet, in parallel, so that a program pays for one
    nvcc run, the longest, and not for each in turn."""
    with _lock:
        if name not in _libs:
            paths = build(KERNELS if name in KERNELS else [name])
            _libs[name] = ctypes.CDLL(str(paths[name]))
        return _libs[name]
