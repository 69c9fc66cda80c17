"""Device selection shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU by name:
with no `device` they take "cuda", and where no card is present they raise
instead of carrying on on the CPU.

On the card, f32 means full f32, as in the JAX reference: resolving a CUDA
device turns TF32 off for cuDNN convolutions and cuBLAS matmuls (PyTorch
runs f32 convolutions in TF32 by default, which costs the 20-epoch demo
protocol ~0.9 dB of PSNR).  bf16 compute (`Config.dtype`) is not affected.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means "cuda".  Raises RuntimeError
    for a CUDA device when no card is available; for an available one,
    turns TF32 off."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
