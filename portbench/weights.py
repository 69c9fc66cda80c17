"""Seeded weights, drawn on the device in one call a network.

The shapes come from the program's networks (their state_dict keys and
sizes, built on the meta device, so nothing is allocated or initialised on
the host).  Which leaves are drawn, and with what spread, is the model
family's rule (families/<family>.py::leaf_std): a drawn leaf takes its
part of one normal draw a network, scaled by its std; a leaf not drawn is
1 where it is a norm's scale (a key ending in '.weight') and 0 otherwise.
The same dict of tensors goes to the program (copied in by
load_state_dict) and to the reference, which clones it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

Shapes = Mapping[str, Mapping[str, Tuple[int, ...]]]
LeafStd = Callable[[str, str, Tuple[int, ...]], Optional[float]]


def shapes_of(nets: Mapping[str, torch.nn.Module]) -> Dict[str, Dict]:
    """{net: {key: shape}} of modules (meta or real)."""
    return {name: {k: tuple(v.shape) for k, v in net.state_dict().items()}
            for name, net in nets.items()}


def draw(shapes: Shapes, seed: int, device, leaf_std: LeafStd
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {key: tensor}} on `device` from `seed`: one normal draw a
    network for the leaves `leaf_std(net, key, shape)` gives a std, split
    and scaled per leaf in state_dict order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for net, leaves in shapes.items():
        stds = {k: leaf_std(net, k, s) for k, s in leaves.items()}
        drawn = [k for k, std in stds.items() if std is not None]
        flat = torch.randn(sum(math.prod(leaves[k]) for k in drawn),
                           generator=gen, device=device)
        sd, at = {}, 0
        for k, shape in leaves.items():
            if stds[k] is not None:
                n = math.prod(shape)
                sd[k] = (flat[at:at + n] * stds[k]).view(shape)
                at += n
            elif k.endswith(".weight"):          # a norm's scale
                sd[k] = torch.ones(shape, device=device)
            else:
                sd[k] = torch.zeros(shape, device=device)
        out[net] = sd
    return out
