"""Operations and bytes of the benchmark's work, worked out from the
networks' layer shapes and the cell's inputs, so they read the same work
whatever implements it, and the peaks they are held against.

  * A conv is counted as a direct convolution: 2 * (weight elements) *
    (output pixels) a sample, a transposed conv 2 * (weight elements) *
    (input pixels).  Norms, activations and the rest are not counted.
  * The attention counts its patch-matching product, 2 * N^2 * C a sample
    in the forward.
  * A backward counts twice its forward for each network whose weights
    take gradients, once where only its input's gradient is taken (netD in
    the generators' phase).  A rematerialised forward is not counted again.
  * The scan's and the attention matrix kernel's least times are those of
    chip_smoke.py's bounds: each byte the inputs need read once and each
    output byte written once, against the published bandwidth; both are
    bound by bytes at every size the cells run.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 67 TFLOP/s f32 outside
the tensor cores (TF32 is off), 989 TFLOP/s bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ATTENTION_LEVEL = 3

Shapes = Mapping[str, Mapping[str, Tuple[int, ...]]]


def _conv_flops(leaves: Mapping[str, Tuple[int, ...]], side) -> float:
    """Sum over the 4-d kernels of 2 * elements * side(key)^2 (a sample);
    side(key) gives the output side of a conv, the input side of a
    transposed conv."""
    return float(sum(2 * math.prod(s) * side(k) ** 2
                     for k, s in leaves.items() if len(s) == 4))


def _level(key: str) -> int:
    return key.count("submodule.")


def net_p_flops(leaves, size: int) -> float:
    """netP: every conv of level i works at size / 2^(i+1)."""
    return _conv_flops(leaves, lambda k: size // 2 ** (_level(k) + 1))


def net_g_flops(leaves, size: int) -> float:
    """netG's convs: level 0 at size, level i at size / 2^i."""
    return _conv_flops(leaves, lambda k: size // 2 ** _level(k))


def attention_flops(leaves, size: int) -> float:
    """2 N^2 C a sample, N = (size/8)^2, C the attention level's width."""
    key = "model." + "submodule." * ATTENTION_LEVEL + "down_conv3.weight"
    c = leaves[key][0]
    n = (size // 8) ** 2
    return 2.0 * n * n * c


def vgg_flops(leaves, size: int, upto: int = 4) -> float:
    """VGG16's conv blocks 1..upto at size, size/2, size/4, size/8."""
    return _conv_flops({k: s for k, s in leaves.items()
                        if int(k[4]) <= upto},
                       lambda k: size // 2 ** (int(k[4]) - 1))


def _out(side: int, k: int, s: int, p: int) -> int:
    return (side + 2 * p - k) // s + 1


def net_d_flops(leaves, size: int) -> float:
    """PatchGAN: k4 s2 p1 convs until the last of conv1.., then a k4 s1
    conv and a k4 s1 head."""
    n_layers = sum(1 for k in leaves if k.startswith("conv")
                   and k.endswith(".weight"))  - 1
    side, sides = size, {}
    for n in range(n_layers + 1):
        side = _out(side, 4, 2 if n < n_layers else 1, 1)
        sides[f"conv{n}."] = side
    sides["head."] = _out(side, 4, 1, 1)
    return _conv_flops(leaves, lambda k: sides[k[:k.index(".") + 1]])


def net_f_flops(leaves, size: int) -> float:
    """Feature PatchGAN on relu3_3 (size/8, at least 8): three k4 s2 p1
    convs."""
    side = max(8, size // 8)
    sides = {}
    for n in range(3):
        side = _out(side, 4, 2, 1)
        sides[f"conv{n}."] = side
    return _conv_flops(leaves, lambda k: sides[k[:k.index(".") + 1]])


def forward_flops(shapes: Shapes, size: int) -> Dict[str, float]:
    """Forward operations a sample of each part at `size`."""
    out = {"P": net_p_flops(shapes["P"], size),
           "G": net_g_flops(shapes["G"], size),
           "attention": attention_flops(shapes["G"], size),
           "vgg4": vgg_flops(shapes["vgg"], size, 4),
           "vgg3": vgg_flops(shapes["vgg"], size, 3)}
    if "D" in shapes:
        out["D"] = net_d_flops(shapes["D"], size)
        out["F"] = net_f_flops(shapes["F"], size)
    return out


def train_flops(shapes: Shapes, size: int, dtype: str) -> Dict[str, float]:
    """Operations an image of one train step, by the precision they run
    in: netP and netG's convs in the compute dtype; the attention, VGG,
    netD and netF in f32.  VGG runs on the reference and the image to
    relu4_3 and on fake_B to relu3_3, without gradients; netD and netF
    take weight gradients on the fake and the real input in their phase;
    in the generators' phase netD runs on fake_B with its input's gradient
    and on the image without one, netF twice without."""
    f = forward_flops(shapes, size)
    out = {"float32": 2 * f["vgg4"] + f["vgg3"] + 9 * f["D"] + 8 * f["F"]
           + 3 * f["attention"]}
    out[dtype] = out.get(dtype, 0.0) + 3 * (f["P"] + f["G"])
    return out


def serve_flops(shapes: Shapes, size: int, dtype: str) -> Dict[str, float]:
    """Operations an image of the inference: VGG of the reference, netP,
    netG in the compute dtype; the attention in f32."""
    f = forward_flops(shapes, size)
    out = {"float32": f["attention"]}
    out[dtype] = out.get(dtype, 0.0) + f["vgg4"] + f["P"] + f["G"]
    return out


def least_seconds(flops: Mapping[str, float]) -> float:
    """The least time of this work on the card: each precision's
    operations over its own peak."""
    return sum(v / PEAK_FLOPS[k] for k, v in flops.items())


def scan_bytes(rows: int, masked: int, c: int) -> int:
    """Bytes the scan needs for `rows` positions of which `masked` are
    masked: every row's flag, known row, output row and (a, b); pn and
    vmax of the masked rows only."""
    return rows * (4 + 4 * c + 4 * c + 8) + masked * (4 * c + 4)


def scan_seconds(rows: int, masked: int, c: int) -> float:
    """The scan's least time: the larger of its bytes over the bandwidth
    and its ~5C+4 f32 operations a masked row over the f32 peak."""
    return max(scan_bytes(rows, masked, c) / HBM_BYTES_PER_S,
               masked * (5 * c + 4) / PEAK_FLOPS["float32"])


def kbar_bytes(bsz: int, n: int, ind_bytes: int = 8) -> int:
    """B*N*N f32 written; flag, a, b (f32) and ind read once."""
    return bsz * n * n * 4 + bsz * n * (12 + ind_bytes)


def kbar_seconds(bsz: int, n: int, ind_bytes: int = 8) -> float:
    """The attention matrix kernel's least time (bytes against three
    operations an element)."""
    return max(kbar_bytes(bsz, n, ind_bytes) / HBM_BYTES_PER_S,
               3 * bsz * n * n / PEAK_FLOPS["float32"])
