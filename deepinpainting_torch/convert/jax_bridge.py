"""Weight bridge: the JAX package's flat per-network parameter dicts ->
state_dicts of the port's networks.

Input is one network's flat dict of numpy arrays, exactly what
deepinpainting_tpu/engine/checkpoint.py::export_network_npz writes (so an
.npz file loads with no JAX present):

  * netG / netP: "/"-joined flax scope paths, e.g.
    "model/submodule/down_conv3/kernel".  The port's modules carry the same
    names (`model.submodule.down_conv3`), so each key is resolved by walking
    its path; nothing is matched by order.
  * VGG16: "{conv}_kernel" / "{conv}_bias", e.g. "conv1_1_kernel".

Layouts (the inverse of deepinpainting_tpu/convert/net_import.py):
  Conv2d kernel HWIO [kh,kw,I,O]         -> weight OIHW [O,I,kh,kw]
  ConvTranspose2d kernel [kh,kw,I,O]     -> weight [I,O,kh,kw] (axes only:
      the JAX kernel is stored in forward orientation and flipped at apply
      time, as torch's ConvTranspose2d flips it)
  InstanceNorm scale / offset            -> weight / bias

Every key must land on a parameter and every parameter must be filled;
anything else raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..ops.convs import InstanceNorm

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "offset": "bias"}


def _split(key: str):
    """(module path, leaf) of a flat key."""
    if "/" in key:
        path, leaf = key.rsplit("/", 1)
        return path.replace("/", "."), leaf
    path, leaf = key.rsplit("_", 1)       # VGG: "conv1_1_kernel"
    return path, leaf


def _convert(layer: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if isinstance(layer, nn.ConvTranspose2d):
            return arr.transpose(2, 3, 0, 1)      # [kh,kw,I,O] -> [I,O,kh,kw]
        if isinstance(layer, nn.Conv2d):
            return arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
        raise ValueError(f"'kernel' on a {type(layer).__name__}")
    if leaf in ("scale", "offset") and not isinstance(layer, InstanceNorm):
        raise ValueError(f"'{leaf}' on a {type(layer).__name__}")
    return arr


def bridge_state_dict(flat: Mapping[str, np.ndarray], module: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """The state_dict for `module` (a UnetGeneratorIPSR, UnetGenerator or
    Vgg16 of the port) from one network's flat JAX parameter dict."""
    want = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        path, leaf = _split(key)
        if leaf not in _LEAF:
            raise KeyError(f"{key}: unknown leaf '{leaf}'")
        try:
            layer = module.get_submodule(path)
        except AttributeError as e:
            raise KeyError(f"{key}: no layer '{path}' in "
                           f"{type(module).__name__}") from e
        name = f"{path}.{_LEAF[leaf]}"
        if name not in want:
            raise KeyError(f"{key}: {name} is not a parameter")
        if name in out:
            raise KeyError(f"{key}: {name} filled twice")
        t = torch.from_numpy(
            np.ascontiguousarray(_convert(layer, leaf, np.asarray(arr)),
                                 dtype=np.float32))
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{name} {tuple(want[name].shape)}")
        out[name] = t
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"parameters not in the flat dict: {missing}")
    return out


def load_flat(module: nn.Module, flat: Mapping[str, np.ndarray]
              ) -> nn.Module:
    """Load a flat JAX parameter dict (or an opened .npz) into `module`."""
    module.load_state_dict(bridge_state_dict(flat, module), strict=True)
    return module
