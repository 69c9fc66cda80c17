"""Device selection shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU by name:
with no `device` they take "cuda", and where no card is present they raise
instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means "cuda".  Raises RuntimeError
    for a CUDA device when no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
