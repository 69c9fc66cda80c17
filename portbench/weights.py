"""Seeded weights, drawn on the device in one call a network.

The shapes come from the program's networks (their state_dict keys and
sizes, built on the meta device, so nothing is allocated or initialised on
the host).  The draw follows the configuration's init: conv kernels from
N(0, init_gain) ('normal'), VGG's from N(0, 2/fan_in), every bias 0,
instance-norm scales 1 and offsets 0.  The same dict of tensors goes to the
program (copied in by load_state_dict) and to the reference, which clones
it.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

Shapes = Mapping[str, Mapping[str, Tuple[int, ...]]]


def shapes_of(nets: Mapping[str, torch.nn.Module]) -> Dict[str, Dict]:
    """{net: {key: shape}} of modules (meta or real)."""
    return {name: {k: tuple(v.shape) for k, v in net.state_dict().items()}
            for name, net in nets.items()}


def draw(shapes: Shapes, seed: int, device, init_gain: float,
         init_type: str = "normal") -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {key: tensor}} on `device` from `seed`: one normal draw a
    network for its conv kernels, split and scaled per leaf."""
    if init_type != "normal":
        raise ValueError(f"init_type {init_type!r}: the benchmark draws "
                         "'normal' weights only")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for net, leaves in shapes.items():
        kernels = [k for k, s in leaves.items() if len(s) == 4]
        flat = torch.randn(sum(math.prod(leaves[k]) for k in kernels),
                           generator=gen, device=device)
        sd, at = {}, 0
        for k, shape in leaves.items():
            if k in kernels:
                n = math.prod(shape)
                std = math.sqrt(2.0 / math.prod(shape[1:])) if net == "vgg" \
                    else init_gain
                sd[k] = (flat[at:at + n] * std).view(shape)
                at += n
            elif k.endswith(".weight"):          # a norm's scale
                sd[k] = torch.ones(shape, device=device)
            else:
                sd[k] = torch.zeros(shape, device=device)
        out[net] = sd
    return out

