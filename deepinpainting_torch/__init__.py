"""PyTorch/CUDA port of the reference-guided inpainting framework.

Mirrors the JAX package's layout (ops/ models/ engine/ serve/ convert/) so
each module's counterpart is found by path.  Imports torch and numpy only:
nothing of JAX and nothing of the JAX package.  The two recurrences of the
IPSR attention run as hand-written CUDA kernels on the card
(csrc/scan_stream.cu in every forward, csrc/kbar_build.cu in the training
forward) and as their plain PyTorch versions on the CPU.
"""

from .config import Config
from .device import resolve_device

__all__ = ["Config", "resolve_device"]
