"""The convolutions ops/convs.py routes to the hand-written f32 kernel
(csrc/conv2d.cu), enumerated from the networks themselves at full width:
each network built on the meta device and run once with forward hooks.
Imports no JAX (the card test and studies/conv_shapes.py use it too).

A call is (layer, kind, geometry): kind 'fwd' for a kernel-4 Conv2d's
forward, 'dgrad' for a ConvTranspose2d's input gradient; the geometry is
the conv2d problem the kernel solves, (B, C, H, W, N, k, stride, padding,
dilation).
"""

from __future__ import annotations

import functools

import torch

from deepinpainting_torch.config import Config
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.models import unet_ipsr
from deepinpainting_torch.ops import conv_cuda
from deepinpainting_torch.ops.convs import Conv2d, ConvTranspose2d

# netD and netF run four times a train step (the D phase and the G phase,
# each on the fake and the real); every other routed layer once.
STEP_CALLS = {"D": 4, "F": 4, "G": 1, "P": 1}


def routed_calls(px: int, batch: int, nets=("G", "P", "D", "F")):
    """[(layer, kind, geometry)] of every kernel-4 Conv2d forward and
    ConvTranspose2d input gradient of the named networks at `px` and
    `batch`, full width (the attention an identity on the meta device)."""
    cfg = Config(fine_size=px, batch_size=batch)
    with torch.device("meta"):
        m, d = TI.build_models(cfg), TI.build_discriminators(cfg)
    rows = []

    def hook(name):
        def f(mod, args, out):
            x, w = args[0], mod.weight
            ks, s, p, dl = (mod.kernel_size[0], mod.stride[0],
                            mod.padding[0], mod.dilation[0])
            if isinstance(mod, ConvTranspose2d):
                rows.append((name, "dgrad", (out.shape[0], w.shape[1],
                                             out.shape[2], out.shape[3],
                                             w.shape[0], ks, s, p, 1)))
            elif ks == 4:
                rows.append((name, "fwd", (x.shape[0], x.shape[1],
                                           x.shape[2], x.shape[3],
                                           w.shape[0], ks, s, p, dl)))
        return f

    by_key = {"G": m.G, "P": m.P, "D": d.D, "F": d.F}
    for key in nets:
        for name, mod in by_key[key].named_modules():
            if isinstance(mod, (Conv2d, ConvTranspose2d)):
                mod.register_forward_hook(hook(f"{key}.{name}"))
    attention = unet_ipsr.ipsr_attention_batched
    unet_ipsr.ipsr_attention_batched = lambda y, *a, **k: y
    try:
        with torch.no_grad(), torch.device("meta"):
            b, h = batch, px
            if "D" in nets:
                d.D(torch.zeros(b, 3, h, h))
            if "F" in nets:
                # netF reads VGG's relu3_3, which is pool3's output: h/8
                f = max(8, h // 8)
                d.F(torch.zeros(b, 256, f, f))
            if "P" in nets:
                m.P(torch.zeros(b, 3, h, h))
            if "G" in nets:
                m.G(torch.zeros(b, 6, h, h),
                    torch.zeros(b, 8 * cfg.ngf, h // 8, h // 8),
                    torch.zeros(b, (h // 8) ** 2))
    finally:
        unet_ipsr.ipsr_attention_batched = attention
    return rows


def gemm(geo):
    """(M, N, K) of a conv2d geometry."""
    b, c, h, w, n, k, s, p, d = geo
    return (b * conv_cuda.out_size(h, k, s, p, d)
            * conv_cuda.out_size(w, k, s, p, d), n, c * k * k)


@functools.lru_cache(maxsize=None)
def hand_calls_per_step(px: int, batch: int, nets) -> int:
    """Launches of the kernel a train step at full width: every routed
    call of `nets` that conv_cuda.takes, times its calls a step."""
    return sum(STEP_CALLS[name[0]] for name, _, geo
               in routed_calls(px, batch, nets)
               if conv_cuda.takes(*gemm(geo), geo[6], geo[8]))


@functools.lru_cache(maxsize=None)
def hand_calls_per_forward(px: int, batch: int, nets="GP") -> int:
    """Launches of the kernel a forward of `nets` without a graph makes at
    full width (a serving call: the U-Nets' kernel-4 down convs that
    conv_cuda.takes; no input gradient)."""
    return sum(1 for _, kind, geo in routed_calls(px, batch, nets)
               if kind == "fwd"
               and conv_cuda.takes(*gemm(geo), geo[6], geo[8]))
