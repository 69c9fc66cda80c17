"""Parameter accounting (counterpart of
deepinpainting_tpu/utils/params.py): the reference's print_network
("Total number of parameters: %d") for the port's modules."""

from __future__ import annotations

import torch.nn as nn


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def print_network(module: nn.Module, name: str = "net") -> int:
    n = count_params(module)
    print(f"[{name}] Total number of parameters: {n}")
    return n


def summarize_state(state) -> dict:
    """Parameter counts of the four trainable networks and the frozen VGG
    of a TrainState."""
    return {net: count_params(getattr(state, net))
            for net in ("G", "P", "D", "F", "vgg")}
