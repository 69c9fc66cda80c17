"""Weight bridge: the JAX package's flat per-network parameter dicts ->
state_dicts of the port's networks, the way back (`flat_dict`), and optax
Adam state -> torch Adam state (`bridge_adam_state`).

Input is one network's flat dict of numpy arrays, exactly what
deepinpainting_tpu/engine/checkpoint.py::export_network_npz writes (so an
.npz file loads with no JAX present):

  * netG / netP: "/"-joined flax scope paths, e.g.
    "model/submodule/down_conv3/kernel".  The port's modules carry the same
    names (`model.submodule.down_conv3`), so each key is resolved by walking
    its path; nothing is matched by order.
  * netD / netF: one level of the same, e.g. "conv1/kernel", "norm1/scale",
    "head/bias".
  * VGG16: "{conv}_kernel" / "{conv}_bias", e.g. "conv1_1_kernel".
  * with norm='batch' a network's state entry is the whole flax variables
    dict, so its keys carry the collection first:
    "params/model/down_conv3/kernel" and
    "batch_stats/model/submodule/down_norm/mean".

Layouts (the inverse of deepinpainting_tpu/convert/net_import.py):
  Conv2d kernel HWIO [kh,kw,I,O]         -> weight OIHW [O,I,kh,kw]
  ConvTranspose2d kernel [kh,kw,I,O]     -> weight [I,O,kh,kw] (axes only:
      the JAX kernel is stored in forward orientation and flipped at apply
      time, as torch's ConvTranspose2d flips it)
  InstanceNorm / BatchNorm scale / offset -> weight / bias
  batch_stats mean / var                 -> running_mean / running_var
      (`num_batches_tracked` has no counterpart and keeps its value)

Every key must land on a parameter and every parameter must be filled;
anything else raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.convs import InstanceNorm

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "offset": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _split(key: str):
    """(module path, leaf, is a running statistic) of a flat key."""
    stats = key.startswith("batch_stats/")
    for prefix in ("params/", "batch_stats/"):
        if key.startswith(prefix):
            key = key[len(prefix):]
    if "/" in key:
        path, leaf = key.rsplit("/", 1)
        return path.replace("/", "."), leaf, stats
    path, leaf = key.rsplit("_", 1)       # VGG: "conv1_1_kernel"
    return path, leaf, stats


def _convert(layer: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if isinstance(layer, nn.ConvTranspose2d):
            return arr.transpose(2, 3, 0, 1)      # [kh,kw,I,O] -> [I,O,kh,kw]
        if isinstance(layer, nn.Conv2d):
            return arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
        raise ValueError(f"'kernel' on a {type(layer).__name__}")
    if leaf in ("scale", "offset") and not isinstance(
            layer, (InstanceNorm, nn.BatchNorm2d)):
        raise ValueError(f"'{leaf}' on a {type(layer).__name__}")
    if leaf in _STATS and not isinstance(layer, nn.BatchNorm2d):
        raise ValueError(f"'{leaf}' on a {type(layer).__name__}")
    return arr


def bridge_tensors(flat: Mapping[str, np.ndarray], module: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """Every entry of a flat JAX dict in `module`'s layout, keyed by its
    state_dict name.  Each key must land on a parameter or buffer of
    `module`; the dict need not be complete (gradients, which have no
    running statistics, convert this way)."""
    want = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        path, leaf, stats = _split(key)
        names = _STATS if stats else _LEAF
        if leaf not in names:
            raise KeyError(f"{key}: unknown leaf '{leaf}'")
        try:
            layer = module.get_submodule(path)
        except AttributeError as e:
            raise KeyError(f"{key}: no layer '{path}' in "
                           f"{type(module).__name__}") from e
        name = f"{path}.{names[leaf]}"
        if name not in want:
            raise KeyError(f"{key}: {name} is not a parameter")
        if name in out:
            raise KeyError(f"{key}: {name} filled twice")
        t = torch.from_numpy(
            np.array(_convert(layer, leaf, np.asarray(arr)),
                     dtype=np.float32, order="C"))
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{name} {tuple(want[name].shape)}")
        out[name] = t
    return out


def bridge_state_dict(flat: Mapping[str, np.ndarray], module: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """The state_dict for `module` (a UnetGeneratorIPSR, UnetGenerator,
    NLayerDiscriminator, PFDiscriminator or Vgg16 of the port) from one
    network's flat JAX parameter dict: every key must land and every
    parameter and running statistic must be filled."""
    want = module.state_dict()
    out = bridge_tensors(flat, module)
    out.update((k, v) for k, v in want.items()
               if k.endswith("num_batches_tracked"))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"parameters not in the flat dict: {missing}")
    return out


def load_flat(module: nn.Module, flat: Mapping[str, np.ndarray],
              assign: bool = False) -> nn.Module:
    """Load a flat JAX parameter dict (or an opened .npz) into `module`.
    assign=True takes the converted tensors as the module's own (for a
    module built on the meta device)."""
    module.load_state_dict(bridge_state_dict(flat, module), strict=True,
                           assign=assign)
    return module


# ---------------------------------------------------------------------------
# the other direction: a port network -> the JAX flat dict
# ---------------------------------------------------------------------------

_LEAF_OF = {"weight": "kernel", "bias": "bias"}
_NORM_LEAF_OF = {"weight": "scale", "bias": "offset", "running_mean": "mean",
                 "running_var": "var"}


def flat_dict(module: nn.Module) -> Dict[str, np.ndarray]:
    """`module`'s parameters and running statistics as the flat dict that
    deepinpainting_tpu/engine/checkpoint.py::export_network_npz writes for
    the same network: the inverse of bridge_state_dict, keyed by the same
    names (VGG's "conv1_1_kernel", "/"-joined paths elsewhere, with the
    "params/" and "batch_stats/" collections when the network has
    BatchNorm)."""
    from ..models.vgg16 import Vgg16
    has_bn = any(isinstance(m, nn.BatchNorm2d) for m in module.modules())
    out: Dict[str, np.ndarray] = {}
    for name, t in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        path, attr = name.rsplit(".", 1)
        layer = module.get_submodule(path)
        arr = t.detach().cpu().numpy()
        if isinstance(layer, (InstanceNorm, nn.BatchNorm2d)):
            leaf = _NORM_LEAF_OF[attr]
        elif isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
            leaf = _LEAF_OF[attr]
            if leaf == "kernel":
                # OIHW -> HWIO; ConvTranspose2d [I,O,kh,kw] -> [kh,kw,I,O]
                arr = arr.transpose((2, 3, 0, 1) if isinstance(
                    layer, nn.ConvTranspose2d) else (2, 3, 1, 0))
        else:
            raise ValueError(f"{name}: no JAX layout for a "
                             f"{type(layer).__name__}")
        if isinstance(module, Vgg16):
            key = f"{path}_{leaf}"
        else:
            key = f"{path.replace('.', '/')}/{leaf}"
            if has_bn:
                key = ("batch_stats/" if leaf in _STATS else "params/") + key
        out[key] = np.ascontiguousarray(arr)
    return out


def bridge_adam_state(opt: torch.optim.Adam, module: nn.Module, count: int,
                      mu: Mapping[str, np.ndarray],
                      nu: Mapping[str, np.ndarray],
                      lr: Optional[float] = None) -> torch.optim.Adam:
    """Load the state of an optax `inject_hyperparams(adam)` chain into the
    torch Adam `opt` that steps `module`'s parameters: optax's count is
    torch's `step` (both count the steps taken; the bias corrections use
    it alike), mu is `exp_avg`, nu `exp_avg_sq`, and `lr` (the injected
    learning rate) goes into every param group.  mu and nu are flat dicts
    of the params subtree, as flat_dict writes them; each moment is matched
    to its parameter by name, never by position."""
    params = dict(module.named_parameters())
    owned = {id(p) for g in opt.param_groups for p in g["params"]}
    if set(map(id, params.values())) != owned:
        raise ValueError("opt does not step exactly module's parameters")
    moments = [bridge_tensors(mu, module), bridge_tensors(nu, module)]
    for m in moments:
        if set(m) != set(params):
            raise KeyError("moments do not cover the parameters: "
                           f"{sorted(set(params) ^ set(m))}")
    for name, p in params.items():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": moments[0][name].to(p.device),
                        "exp_avg_sq": moments[1][name].to(p.device)}
    if lr is not None:
        for group in opt.param_groups:
            group["lr"] = float(lr)
    return opt
