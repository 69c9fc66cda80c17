"""PyTorch/CUDA port of the reference-guided inpainting framework.

Mirrors the JAX package's layout (ops/ models/ engine/ serve/ convert/) so
each module's counterpart is found by path.  Imports torch and numpy only:
nothing of JAX and nothing of the JAX package.  The IPSR coherence scan runs
as a hand-written CUDA kernel (csrc/scan_stream.cu) on the card and as its
plain PyTorch version on the CPU.
"""

from .config import Config
from .device import resolve_device

__all__ = ["Config", "resolve_device"]
