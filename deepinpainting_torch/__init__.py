"""PyTorch/CUDA port of the reference-guided inpainting framework.

Mirrors the JAX package's layout (ops/ models/ engine/ data/ serve/
convert/ utils/) so each module's counterpart is found by path.  Imports
torch and numpy only: nothing of JAX and nothing of the JAX package.  The
two recurrences of the IPSR attention run as hand-written CUDA kernels on
the card (csrc/scan_stream.cu in every forward, csrc/kbar_build.cu in the
training forward) and as their plain PyTorch versions on the CPU.

Importing the package itself loads no torch: the data loader's spawned
worker processes import it, and `resolve_device` (which needs torch) is
loaded on first access.
"""

from .config import Config

__all__ = ["Config", "resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
