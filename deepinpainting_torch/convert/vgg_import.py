"""torchvision VGG16 -> npz weight converter (counterpart of
deepinpainting_tpu/convert/vgg_import.py).

The reference loads `torchvision.models.vgg16(pretrained=True)` when it
builds its model.  Here the pretrained weights enter through a file: run

    python -m deepinpainting_torch.convert.vgg_import vgg16.pth vgg16.npz

once wherever torchvision's weights exist (its state_dict file, or a
pickled model), and point `Config.vgg_weights` at the npz.  The npz is the
JAX package's layout, so one file serves both packages: the port loads it
through `convert/jax_bridge.py::load_flat` (engine/inpaint.py::init_params).

Layout: torchvision's `features.{idx}.weight` [O,I,3,3] -> `{name}_kernel`
HWIO [3,3,I,O] and `features.{idx}.bias` -> `{name}_bias`, for the ten convs
that feed the four slices (features 0, 2, 5, 7, 10, 12, 14, 17, 19, 21; the
slices stop at index 23).  conv5 and the classifier are skipped.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# torchvision vgg16 `features` conv indices -> the slice convs' names
VGG16_FEATURES_INDEX = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
}


def _float32(value) -> np.ndarray:
    """A tensor or array as a float32 numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, dtype=np.float32)


def convert_vgg16_state_dict(state_dict: Mapping[str, object]
                             ) -> Dict[str, np.ndarray]:
    """A torchvision VGG16 state_dict (tensors or arrays) -> the flat npz
    dict: `conv1_1_kernel` (HWIO, float32), `conv1_1_bias`, ... for the ten
    slice convs.

    Accepts bare `features.N.*` keys (torchvision's state_dict file) and
    prefixed ones (`vgg.features.N.*`).  Raises ValueError naming every
    missing conv weight or bias.
    """
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if "features" not in parts:
            continue
        fi = parts.index("features")
        name = VGG16_FEATURES_INDEX.get(int(parts[fi + 1]))
        if name is None:
            continue        # conv5_* and the pools' indices are unused
        kind = parts[fi + 2]
        if kind == "weight":
            out[name + "_kernel"] = np.ascontiguousarray(
                _float32(value).transpose(2, 3, 1, 0))     # OIHW -> HWIO
        elif kind == "bias":
            out[name + "_bias"] = _float32(value)
    missing = [f"{n}_{k}" for n in VGG16_FEATURES_INDEX.values()
               for k in ("kernel", "bias") if f"{n}_{k}" not in out]
    if missing:
        raise ValueError(f"state_dict is missing VGG16 convs: {missing}")
    return out


def torch_file_to_npz(pth_path: str, npz_path: str) -> None:
    """Convert a .pth file holding a state_dict or a pickled module (whose
    state_dict() is taken).  The file is unpickled in full, as torch.load
    does with weights_only=False: convert only files you trust."""
    obj = torch.load(pth_path, map_location="cpu", weights_only=False)
    state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
    np.savez(npz_path, **convert_vgg16_state_dict(state_dict))


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="convert a torchvision VGG16 .pth into the npz that "
                    "Config.vgg_weights names")
    ap.add_argument("pth", help="torchvision vgg16 .pth (state_dict or "
                                "pickled model)")
    ap.add_argument("npz", help="output .npz path")
    args = ap.parse_args(argv)
    torch_file_to_npz(args.pth, args.npz)
    print(f"wrote {args.npz}")


if __name__ == "__main__":
    main()
