"""Reference checkpoint importer: a reference network (its
`{epoch}_net_{G,P,D,F}.pt` state_dicts, loaded into the reference's torch
module) -> the port's network of the same architecture (counterpart of
deepinpainting_tpu/convert/net_import.py).

The reference builds each network as nested `nn.Sequential`s whose
pre-order module walk visits the layers that hold weights (Conv2d,
ConvTranspose2d, InstanceNorm2d, BatchNorm2d) in execution order.  The
port's networks run the same layers in the same order, so two ordered
walks, aligned by layer kind and shape, map one onto the other with no
coupling of names:

  * the torch side: `module.modules()` in pre-order, by class name; an
    InstanceNorm2d without affine parameters holds nothing and is skipped;
  * the port side: `named_children`, sorted by each name's place in the
    forward (`_EXEC_ORDER`).  Registration order is not relied on: an
    `__init__` that registered its layers in another order would
    otherwise shift every weight by one layer.  Children that hold no
    parameter and no buffer (dropout) are skipped before the lookup.

Layouts need no conversion: the reference's Conv2d OIHW, ConvTranspose2d
[I, O, kh, kw] and norm weight / bias are the port's own, so tensors are
copied as they are (the JAX importer transposes them into its layouts).
Every tensor comes out float32.  The port knows its layer types, so a torch
Conv2d that would land on a port ConvTranspose2d is refused, where the JAX
importer can only tell a norm from a conv.

With norm='batch' the BatchNorm running statistics are mapped by a second
walk of the same order; `num_batches_tracked` is copied from the torch
module.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.convs import InstanceNorm

_KIND_BY_TORCH_CLASS = {
    "Conv2d": "conv",
    "ConvTranspose2d": "convT",
    "InstanceNorm2d": "norm",
    "BatchNorm2d": "norm",   # weight / bias like instance; the running
                             # buffers are mapped by the BatchNorm walk
}

# Place of each child name in its module's forward.  Names that never share
# a module may share a place.
_EXEC_ORDER = {
    # U-Net blocks (models/unet.py, models/unet_ipsr.py)
    "down_conv": 0, "down_dilconv": 0, "down_norm": 1, "down_conv3": 2,
    "down_norm3": 3, "submodule": 4, "model": 4,
    "up_conv3": 5, "up_norm3": 6, "up_conv": 7, "up_norm": 8,
    # discriminators (convN runs before normN runs before conv(N+1))
    "conv0": 0, "conv1": 2, "norm1": 3, "conv2": 4, "norm2": 5,
    "conv3": 6, "norm3": 7, "head": 10,
}

Layer = Tuple[str, torch.Tensor, Optional[torch.Tensor]]


def collect_torch_layers(module: nn.Module) -> List[Layer]:
    """Pre-order walk of a reference torch module -> [(kind, weight,
    bias)] in execution order (nn.Sequential children in index order)."""
    out = []
    for m in module.modules():
        kind = _KIND_BY_TORCH_CLASS.get(type(m).__name__)
        if kind is None or (kind == "norm" and m.weight is None):
            continue
        out.append((kind, m.weight, m.bias))
    return out


def _exec_sorted(names):
    try:
        return sorted(names, key=lambda n: (_EXEC_ORDER[n], n))
    except KeyError as e:
        raise ValueError(f"scope name {e} has no execution-order entry; "
                         f"extend _EXEC_ORDER in net_import.py") from e


def _port_kind(layer: nn.Module) -> Optional[str]:
    if isinstance(layer, nn.ConvTranspose2d):
        return "convT"
    if isinstance(layer, nn.Conv2d):
        return "conv"
    if isinstance(layer, (InstanceNorm, nn.BatchNorm2d)):
        return "norm"
    return None


def _holds_state(module: nn.Module) -> bool:
    return any(True for _ in module.parameters()) or any(
        True for _ in module.buffers())


def collect_port_slots(net: nn.Module, prefix: str = ""
                       ) -> List[Tuple[str, str, nn.Module]]:
    """Execution-ordered walk of a port network -> [(path, kind, layer)],
    path as in its state_dict ("model.submodule.down_conv3").  Raises
    ValueError for a child that holds parameters and has no _EXEC_ORDER
    entry."""
    children = {n: c for n, c in net.named_children() if _holds_state(c)}
    slots = []
    for name in _exec_sorted(children):
        child, path = children[name], prefix + name
        kind = _port_kind(child)
        if kind is None:
            slots.extend(collect_port_slots(child, path + "."))
        else:
            slots.append((path, kind, child))
    return slots


def _shape(t: Optional[torch.Tensor]):
    return None if t is None else tuple(t.shape)


def _copy(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` as a detached float32 copy (or `like`'s dtype for an integer
    buffer) on `like`'s device."""
    dtype = like.dtype if not like.is_floating_point() else torch.float32
    return t.detach().to(like.device, dtype, copy=True)


def _collect_torch_bn_stats(module: nn.Module):
    """Pre-order walk -> [(running_mean, running_var, num_batches_tracked)]
    of every BatchNorm2d that tracks running statistics."""
    return [(m.running_mean, m.running_var, m.num_batches_tracked)
            for m in module.modules()
            if type(m).__name__ == "BatchNorm2d"
            and m.running_mean is not None]


def torch_module_to_state_dict(torch_module: nn.Module, port_net: nn.Module
                               ) -> Dict[str, torch.Tensor]:
    """The state_dict of `port_net` (a port UnetGeneratorIPSR,
    UnetGenerator, NLayerDiscriminator or PFDiscriminator) holding the
    weights of `torch_module`, the reference network of the same
    architecture.  Each tensor is a float32 copy on the device of the port
    tensor it replaces; with BatchNorm the running statistics come along
    and `num_batches_tracked` is the torch module's.  Raises ValueError
    when the walks disagree: "layer count mismatch", "kind mismatch",
    "shape mismatch" (a bias present on one side only included),
    "BatchNorm count mismatch"."""
    layers = collect_torch_layers(torch_module)
    slots = collect_port_slots(port_net)
    if len(layers) != len(slots):
        raise ValueError(
            f"layer count mismatch: torch has {len(layers)}, port net has "
            f"{len(slots)} — architectures disagree")
    out: Dict[str, torch.Tensor] = {}
    for (kind, w, b), (path, slot_kind, layer) in zip(layers, slots):
        if kind != slot_kind:
            raise ValueError(f"kind mismatch at {path}: torch {kind} vs "
                             f"port {slot_kind} ({type(layer).__name__})")
        for name, t in (("weight", w), ("bias", b)):
            want = getattr(layer, name)
            if _shape(t) != _shape(want):
                raise ValueError(f"shape mismatch at {path}.{name}: torch "
                                 f"{_shape(t)} vs port {_shape(want)}")
            if t is not None:
                out[f"{path}.{name}"] = _copy(t, want)

    stats = _collect_torch_bn_stats(torch_module)
    bn_slots = [(path, layer) for path, _, layer in slots
                if isinstance(layer, nn.BatchNorm2d)]
    if len(stats) != len(bn_slots):
        raise ValueError(
            f"BatchNorm count mismatch: torch has {len(stats)}, port net "
            f"has {len(bn_slots)} — architectures disagree")
    for (mean, var, count), (path, layer) in zip(stats, bn_slots):
        if mean.shape != layer.running_mean.shape:
            raise ValueError(f"stats shape mismatch at {path}: torch "
                             f"{_shape(mean)} vs port "
                             f"{_shape(layer.running_mean)}")
        out[f"{path}.running_mean"] = _copy(mean, layer.running_mean)
        out[f"{path}.running_var"] = _copy(var, layer.running_var)
        out[f"{path}.num_batches_tracked"] = _copy(
            count, layer.num_batches_tracked)
    return out


def load_torch_module(port_net: nn.Module, torch_module: nn.Module
                      ) -> nn.Module:
    """Load the weights (and BatchNorm statistics) of the reference network
    `torch_module` into `port_net`, in place, and return it."""
    port_net.load_state_dict(
        torch_module_to_state_dict(torch_module, port_net), strict=True)
    return port_net


def torch_state_dict_to_module(state_dict, builder: Callable[[], nn.Module],
                               port_net: nn.Module) -> nn.Module:
    """Load a reference `{epoch}_net_X.pt` state_dict into `port_net`:
    `builder()` constructs the matching reference torch module (define_G
    or define_D with the run's flags), which is filled from the state_dict
    and then mapped."""
    module = builder()
    module.load_state_dict(state_dict)
    return load_torch_module(port_net, module)
