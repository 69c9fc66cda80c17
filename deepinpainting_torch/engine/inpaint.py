"""The inference half of the inpainting engine (counterpart of
deepinpainting_tpu/engine/inpaint.py): model factory, weight init, input
preparation and the two-stage forward.

Data flow, as the JAX package's:

  netP input : gt with the hole filled by fixed ImageNet-mean constants
  compose    : syn = fake_P.detach() * mask + gt * (1 - mask)
  netG input : cat([syn, gt * (1 - mask)], channels) — the zero-holed image,
               as the reference's in-place masked_fill aliasing produces
  output     : fake_B (linear), and uint8 floor(clip((x+1)*127.5, 0, 255))
               for serving

The public functions take and return the JAX layout (NHWC images, [B,H,W]
masks) so the two packages compare like with like; images go to NCHW once
inside and the results come back to NHWC once.  Entry points run on
"cuda" unless given device="cpu".
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..models.unet import UnetGenerator
from ..models.unet_ipsr import UnetGeneratorIPSR
from ..models.vgg16 import Vgg16
from ..ops import masks as M
from ..ops.attention import check_impl
from ..ops.convs import INIT_TYPES, InstanceNorm, init_weight_


class Models(NamedTuple):
    G: UnetGeneratorIPSR
    P: UnetGenerator
    vgg: Vgg16


def check_config(cfg: Config) -> int:
    """The JAX package's build_models checks, plus a refusal of every
    option the port does not run yet.  Returns the U-Nets' num_downs."""
    if cfg.which_model_netG != "unet_ipsr":
        raise NotImplementedError(cfg.which_model_netG)
    if cfg.which_model_netP != "unet_256":
        raise NotImplementedError(cfg.which_model_netP)
    if cfg.which_model_netD != "basic":
        raise NotImplementedError(cfg.which_model_netD)
    if cfg.which_model_netF != "feature":
        raise NotImplementedError(cfg.which_model_netF)
    if cfg.norm not in ("instance", "batch"):
        raise NotImplementedError(
            f"normalization layer [{cfg.norm}] is not found "
            "(supported: 'instance', 'batch')")
    if cfg.init_type not in INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{cfg.init_type}] is not implemented")
    if cfg.quant not in ("none", "int8"):
        raise NotImplementedError(
            f"quant mode [{cfg.quant}] is not implemented "
            "(only 'none' and 'int8' are supported)")
    # Options the JAX package has and the port does not run yet.
    for name, value, ok in (("norm", cfg.norm, "instance"),
                            ("quant", cfg.quant, "none"),
                            ("dtype", cfg.dtype, "float32"),
                            ("pack_small_cin", cfg.pack_small_cin, False),
                            ("pack_out", cfg.pack_out, False)):
        if value != ok:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (port runs {ok!r})")
    check_impl(cfg.attention_impl)
    num_downs = max(6, int(math.log2(cfg.fine_size)))
    if cfg.fine_size < 2 ** 6:
        # netP's innermost k4s2p1 conv then sees a 1x1 map, which the JAX
        # package turns into an empty one and torch refuses.
        raise ValueError(f"fine_size {cfg.fine_size} < 64 is not supported")
    feat_c = max(1, int(512 * cfg.vgg_width_scale))
    if cfg.ngf * 8 != feat_c:
        raise ValueError(
            f"attention requires ngf*8 ({cfg.ngf * 8}) == VGG relu4_3 "
            f"channels ({feat_c}); adjust ngf or vgg_width_scale")
    return num_downs


def build_models(cfg: Config) -> Models:
    """Network factory (the role of define_G / vgg16), after check_config."""
    num_downs = check_config(cfg)
    return Models(
        G=UnetGeneratorIPSR(input_nc=cfg.input_nc_g, output_nc=cfg.output_nc,
                            num_downs=num_downs, ngf=cfg.ngf,
                            use_dropout=cfg.use_dropout,
                            known_replacement=cfg.faithful_known_replacement),
        P=UnetGenerator(input_nc=cfg.input_nc, output_nc=cfg.output_nc,
                        num_downs=num_downs, ngf=cfg.ngf,
                        use_dropout=cfg.use_dropout),
        vgg=Vgg16(cfg.vgg_width_scale),
    )


def init_params(cfg: Config, generator: torch.Generator,
                device: DeviceLike = None) -> Models:
    """Build the three inference networks with weights drawn from
    `generator` (a CPU torch.Generator) by cfg.init_type / init_gain, as
    the JAX package's init draws them; VGG from he_normal unless
    cfg.vgg_weights names a converted .npz.  Returns them in eval mode on
    `device`."""
    dev = resolve_device(device)
    models = build_models(cfg)
    for net in (models.G, models.P):
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                init_weight_(m.weight, cfg.init_type, cfg.init_gain,
                             generator)
                torch.nn.init.zeros_(m.bias)
            elif isinstance(m, InstanceNorm):
                torch.nn.init.ones_(m.weight)
                torch.nn.init.zeros_(m.bias)
    if cfg.vgg_weights and cfg.vgg_weights != "random":
        if cfg.vgg_width_scale != 1.0:
            raise ValueError("pretrained VGG weights require full width")
        from ..convert.jax_bridge import load_flat
        with np.load(cfg.vgg_weights) as raw:
            load_flat(models.vgg, raw)
    else:
        models.vgg.reset_parameters(generator)
    return Models(*(net.to(dev).eval() for net in models))


# ---------------------------------------------------------------------------
# input preparation
# ---------------------------------------------------------------------------

def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> x/127.5 - 1 in f32; float inputs pass through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x


def normalize_mask(m: torch.Tensor) -> torch.Tensor:
    """Non-f32 masks binarize as (m > 0); f32 masks pass through."""
    if m.dtype != torch.float32:
        return (m > 0).to(torch.float32)
    return m


def prepare_masks(cfg: Config, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask: [B,H,W] float 1=hole.  Returns (feat_mask [B,h,w],
    flag [B,h*w])."""
    fmask = M.feat_mask(mask, 3, cfg.threshold)
    flag = M.patch_flags(fmask, cfg.shift_sz, cfg.stride, cfg.mask_thred)
    return fmask, flag


def resolve_mask(cfg: Config, mask: torch.Tensor) -> torch.Tensor:
    """'center' ignores the input mask and uses the fixed center square;
    'random' uses it as it is."""
    if cfg.mask_type == "center":
        b, h, w = mask.shape
        return M.center_mask(cfg.fine_size, cfg.overlap,
                             device=mask.device).expand(b, h, w)
    if cfg.mask_type == "random":
        return mask
    raise ValueError(f"mask_type {cfg.mask_type!r} not recognized")


class ForwardOut(NamedTuple):
    fake_P: torch.Tensor       # NCHW
    fake_B: torch.Tensor       # NCHW
    taps: Dict[str, torch.Tensor]


def two_stage_forward(G: UnetGeneratorIPSR, P: UnetGenerator,
                      gt: torch.Tensor, mask: torch.Tensor,
                      ref_feat: torch.Tensor, flag: torch.Tensor,
                      attention_impl=None) -> ForwardOut:
    """Eval-mode two-stage forward on NCHW images: gt [B,3,H,W],
    mask [B,H,W], ref_feat [B,8ngf,H/8,W/8], flag [B,(H/8)*(W/8)]."""
    masked_mean = M.fill_hole_with_mean(gt, mask)
    fake_P = P(masked_mean)
    known = M.zero_hole(gt, mask)
    syn = fake_P.detach() * mask[:, None] + known
    middle = torch.cat([syn, known], dim=1)
    fake_B, taps = G(middle, ref_feat, flag, attention_impl)
    return ForwardOut(fake_P, fake_B, taps)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def make_inference_fn(cfg: Config, device: DeviceLike = None):
    """infer(G, P, vgg, gt, mask, ref) -> (fake_B, fake_P), NHWC f32 on
    `device`.  gt/ref: [B,H,W,3] uint8 (or [-1,1] f32), numpy or tensor;
    mask [B,H,W] (uint8 0/1, or f32).  The networks must already be on
    `device` and in eval mode (init_params returns them so)."""
    dev = resolve_device(device)
    check_config(cfg)
    impl = check_impl(cfg.attention_impl)

    @torch.inference_mode()
    def infer(G, P, vgg, gt, mask, ref):
        gt = normalize_image(_as_tensor(gt, dev)).permute(0, 3, 1, 2)
        ref = normalize_image(_as_tensor(ref, dev)).permute(0, 3, 1, 2)
        mask = resolve_mask(cfg, normalize_mask(_as_tensor(mask, dev)))
        _, flag = prepare_masks(cfg, mask)
        ref_feat = vgg(ref).relu4_3
        fwd = two_stage_forward(G, P, gt, mask, ref_feat, flag, impl)
        return (fwd.fake_B.permute(0, 2, 3, 1),
                fwd.fake_P.permute(0, 2, 3, 1))

    return infer


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """tensor2im quantization: floor(clip((x+1)*127.5, 0, 255))."""
    return torch.floor(torch.clamp((x + 1.0) * 127.5, 0.0, 255.0)
                       ).to(torch.uint8)


def make_serving_fn(cfg: Config, device: DeviceLike = None):
    """serve(G, P, vgg, gt, mask, ref) -> uint8 [B,H,W,3] on `device`;
    the quantization runs on the device, so 1 byte/px crosses to the
    host."""
    infer = make_inference_fn(cfg, device)

    def serve_fn(G, P, vgg, gt, mask, ref):
        fake_B, _ = infer(G, P, vgg, gt, mask, ref)
        return to_uint8(fake_B)

    return serve_fn
