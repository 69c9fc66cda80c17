"""The inpainting engine (counterpart of
deepinpainting_tpu/engine/inpaint.py): model factory, weight init, input
preparation, the two-stage forward, the inference and serving functions,
the GAN train step, the eval step and the coarse stage.

Data flow, as the JAX package's:

  netP input : gt with the hole filled by fixed ImageNet-mean constants
  compose    : syn = fake_P.detach() * mask + gt * (1 - mask)
  netG input : cat([syn, gt * (1 - mask)], channels) — the zero-holed image,
               as the reference's in-place masked_fill aliasing produces
  output     : fake_B (linear), and uint8 floor(clip((x+1)*127.5, 0, 255))
               for serving
  train step : one forward of P and G; D and F step first on the detached
               fake_B, then G and P train against the *updated*
               discriminators.  G's feature-GAN branch is constant with
               respect to G (VGG of the detached fake_B), and the InnerCos
               losses enter loss_G detached under faithful_detached_cosis.
               With norm='batch' every train-mode forward moves its
               BatchNorm running statistics: G's and P's once a step, D's
               four times (fake then real, in both phases).
  dtype      : cfg.dtype='bfloat16' casts the inputs of netP and netG (and
               the reference feature) to bf16 at this boundary and their
               outputs and taps back to f32, so losses and metrics stay
               f32; parameters and Adam stay f32.  VGG runs in bf16 only in
               the inference function, as the JAX package's.
  remat      : cfg.remat checkpoints the remat_depth outermost U-Net levels
               (models/remat.py); the step's results are those without it.
  grad_accum : k > 1 splits the batch into k microbatches
               (_make_accum_train_step).
  conv modes : cfg.quant='int8' (inference only), pack_small_cin and
               pack_out apply to every conv of the networks an entry point
               runs, as the JAX package's conv_modes(cfg) applies them:
               each entry point runs its body inside ops/convs.py's
               conv_modes(cfg), with a group or a Grid too (int8 scales
               by the maximum over the global batch and the whole image).
  group      : the train and eval steps take an optional torch.distributed
               group (parallel/mesh.py): the step is then one rank's share
               of the step on the global batch, whose relativistic means
               and BatchNorm moments are the global batch's
               (parallel/collectives.py), whose gradients are averaged over
               the ranks before each phase's update, and whose metrics are
               the global means.  A Grid (parallel/spatial.py) in its place
               adds spatial partitioning: the rank holds a slab of rows of
               its data group's images, and so do the steps' and the
               inference function's inputs and fake_B / fake_P.
  the sum    : under spatial partitioning every rank's loss is the whole
               loss of its data group's rows, the same on each rank of its
               sp group: the L1 means are over every slab (all-reduced),
               and what runs on gathered images (the attention level and
               InnerCos, VGG, netD and netF) is whole on every rank.  The
               collectives' backward passes take the step's objective as
               the sum of every rank's loss, n_sp times the data groups'
               losses, so the parameter gradients are averaged over the
               whole grid, data x sp, in the one flat all-reduce a phase:
               summed over sp that counts the replicated work once, not
               n_sp times, and averaged over data as without the spatial
               axis.

The public functions take and return the JAX layout (NHWC images, [B,H,W]
masks) so the two packages compare like with like; images go to NCHW once
inside and the results come back to NHWC once.  Entry points run on
"cuda" unless given device="cpu".
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..losses import inner_cos_loss, l1_loss, ra_gan_loss
from ..models.discriminators import NLayerDiscriminator, PFDiscriminator
from ..models.unet import UnetGenerator
from ..models.unet_ipsr import UnetGeneratorIPSR
from ..models.vgg16 import Vgg16
from ..ops import masks as M
from ..ops.attention import check_impl
from ..ops.convs import (INIT_TYPES, NORMS, InstanceNorm, conv_modes,
                         frozen_running_stats, init_weight_)
from ..parallel.collectives import (all_reduce_mean, as_grid, full_rows,
                                    own_rows, replicated, use_grid)
from ..utils.profiling import span
from .state import TrainState, create_train_state


class Models(NamedTuple):
    """What inference needs."""
    G: UnetGeneratorIPSR
    P: UnetGenerator
    vgg: Vgg16


class Discriminators(NamedTuple):
    """What training adds."""
    D: NLayerDiscriminator
    F: PFDiscriminator


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    """The activation dtype of netP and netG (cfg.dtype)."""
    return COMPUTE_DTYPES[cfg.dtype]


def check_config(cfg: Config) -> int:
    """The JAX package's build_models checks, plus a refusal of every
    option the port does not run.  Returns the U-Nets' num_downs."""
    if cfg.which_model_netG != "unet_ipsr":
        raise NotImplementedError(cfg.which_model_netG)
    if cfg.which_model_netP != "unet_256":
        raise NotImplementedError(cfg.which_model_netP)
    if cfg.which_model_netD != "basic":
        raise NotImplementedError(cfg.which_model_netD)
    if cfg.which_model_netF != "feature":
        raise NotImplementedError(cfg.which_model_netF)
    if cfg.norm not in NORMS:
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
    if cfg.dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"dtype={cfg.dtype!r} is not ported (port runs "
            f"{' or '.join(map(repr, COMPUTE_DTYPES))})")
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


def check_train_config(cfg: Config) -> None:
    """check_config, plus the training options' checks."""
    check_config(cfg)
    if cfg.quant != "none":
        # gradients through round() are zero: int8 is inference-only
        raise NotImplementedError(
            f"quant={cfg.quant!r} is inference-only; training runs full "
            "precision")
    if cfg.gan_type not in ("lsgan", "wgan_gp", "vanilla"):
        raise ValueError(f"unknown gan_type {cfg.gan_type!r}")


def build_models(cfg: Config) -> Models:
    """Network factory (the role of define_G / vgg16), after check_config."""
    num_downs = check_config(cfg)
    return Models(
        G=UnetGeneratorIPSR(input_nc=cfg.input_nc_g, output_nc=cfg.output_nc,
                            num_downs=num_downs, ngf=cfg.ngf,
                            use_dropout=cfg.use_dropout,
                            known_replacement=cfg.faithful_known_replacement,
                            triple_weight=cfg.triple_weight,
                            truncate_backward=cfg.faithful_backward_truncation,
                            norm=cfg.norm, remat=cfg.remat,
                            remat_depth=cfg.remat_depth),
        P=UnetGenerator(input_nc=cfg.input_nc, output_nc=cfg.output_nc,
                        num_downs=num_downs, ngf=cfg.ngf,
                        use_dropout=cfg.use_dropout, norm=cfg.norm,
                        remat=cfg.remat, remat_depth=cfg.remat_depth),
        vgg=Vgg16(cfg.vgg_width_scale),
    )


def build_discriminators(cfg: Config) -> Discriminators:
    """Discriminator factory (the role of define_D), after check_config.
    netD ends in a sigmoid for gan_type 'vanilla' only."""
    check_config(cfg)
    return Discriminators(
        D=NLayerDiscriminator(input_nc=cfg.input_nc, ndf=cfg.ndf,
                              use_sigmoid=cfg.gan_type == "vanilla",
                              norm=cfg.norm),
        F=PFDiscriminator(
            in_channels=max(1, int(256 * cfg.vgg_width_scale)),
            width=max(1, int(512 * cfg.vgg_width_scale))),
    )


def _init_net_(net: torch.nn.Module, cfg: Config,
               generator: torch.Generator) -> None:
    """Conv kernels by cfg.init_type / init_gain, biases 0, InstanceNorm
    affine (1, 0), BatchNorm scale from N(1, init_gain) for every
    init_type, as the JAX package's init draws them."""
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            init_weight_(m.weight, cfg.init_type, cfg.init_gain, generator)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
        elif isinstance(m, InstanceNorm):
            torch.nn.init.ones_(m.weight)
            torch.nn.init.zeros_(m.bias)
        elif isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.copy_(1.0 + cfg.init_gain * torch.randn(
                    m.weight.shape, generator=generator))
            torch.nn.init.zeros_(m.bias)
            m.reset_running_stats()


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
        _init_net_(net, cfg, generator)
    if cfg.vgg_weights and cfg.vgg_weights != "random":
        if cfg.vgg_width_scale != 1.0:
            raise ValueError("pretrained VGG weights require full width")
        from ..convert.jax_bridge import load_flat
        with np.load(cfg.vgg_weights) as raw:
            load_flat(models.vgg, raw)
    else:
        models.vgg.reset_parameters(generator)
    return Models(*(net.to(dev).eval() for net in models))


def init_discriminators(cfg: Config, generator: torch.Generator,
                        device: DeviceLike = None) -> Discriminators:
    """netD and netF with weights drawn from `generator` like the
    generators', in train mode on `device`."""
    dev = resolve_device(device)
    nets = build_discriminators(cfg)
    for net in nets:
        _init_net_(net, cfg, generator)
    return Discriminators(*(net.to(dev).train() for net in nets))


def create_state(cfg: Config, generator: torch.Generator,
                 device: DeviceLike = None) -> TrainState:
    """A fresh TrainState on `device`: G, P and VGG drawn as init_params
    draws them (so one seed gives serving and training the same
    generators), then D and F, then four Adam optimisers.  G, P, D and F
    come back in train mode."""
    dev = resolve_device(device)
    check_train_config(cfg)
    G, P, vgg = init_params(cfg, generator, dev)
    D, F = init_discriminators(cfg, generator, dev)
    return create_train_state(cfg, G.train(), P.train(), D, F, vgg)


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


def _masks(cfg: Config, mask: torch.Tensor):
    """(the resolved mask, feat_mask, flag) of an input mask.  On a slab
    (spatial partitioning) the mask is resolved and its pyramid built on
    the gathered mask (small: H*W f32 a sample), and the resolved mask
    comes back as this rank's rows."""
    full = resolve_mask(cfg, full_rows(normalize_mask(mask), dim=1))
    fmask, flag = prepare_masks(cfg, full)
    return own_rows(full, dim=1), fmask, flag


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
    masked_mean: torch.Tensor  # netP input: the hole filled with the mean
    known: torch.Tensor        # zero-holed gt (the reference's real_A)
    syn: torch.Tensor          # fake_P in the hole, gt outside


def two_stage_forward(G: UnetGeneratorIPSR, P: UnetGenerator,
                      gt: torch.Tensor, mask: torch.Tensor,
                      ref_feat: torch.Tensor, flag: torch.Tensor,
                      attention_impl=None,
                      generator: Optional[torch.Generator] = None,
                      dtype: torch.dtype = torch.float32) -> ForwardOut:
    """Two-stage forward on NCHW images: gt [B,3,H,W], mask [B,H,W],
    ref_feat [B,8ngf,H/8,W/8], flag [B,(H/8)*(W/8)].  Train or eval is the
    networks' own mode; `generator` feeds the dropout in train mode.
    `dtype` is the networks' compute dtype: their inputs are cast to it,
    fake_P, fake_B and the taps come back in f32."""
    masked_mean = M.fill_hole_with_mean(gt, mask)
    fake_P = P(masked_mean.to(dtype), generator).to(torch.float32)
    known = M.zero_hole(gt, mask)
    syn = fake_P.detach() * mask[:, None] + known
    middle = torch.cat([syn, known], dim=1)
    fake_B, taps = G(middle.to(dtype), ref_feat.to(dtype), flag,
                     attention_impl, generator)
    return ForwardOut(fake_P, fake_B.to(torch.float32),
                      {k: v.to(torch.float32) for k, v in taps.items()},
                      masked_mean, known, syn)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _inference_body(cfg: Config, dev: torch.device, grid=None):
    """The body of the inference function, with no grad-mode context of
    its own."""
    check_config(cfg)
    impl = check_impl(cfg.attention_impl)
    dt = compute_dtype(cfg)

    def infer(G, P, vgg, gt, mask, ref):
        with conv_modes(cfg), use_grid(grid):
            return _infer(G, P, vgg, gt, mask, ref)

    def _infer(G, P, vgg, gt, mask, ref):
        gt = normalize_image(_as_tensor(gt, dev)).permute(0, 3, 1, 2)
        ref = normalize_image(_as_tensor(ref, dev)).permute(0, 3, 1, 2)
        mask, _, flag = _masks(cfg, _as_tensor(mask, dev))
        # inference only: VGG runs in the compute dtype too
        ref_feat = vgg(ref.to(dt)).relu4_3
        fwd = two_stage_forward(G, P, gt, mask, ref_feat, flag, impl,
                                dtype=dt)
        return (fwd.fake_B.permute(0, 2, 3, 1),
                fwd.fake_P.permute(0, 2, 3, 1))

    return infer


def make_inference_fn(cfg: Config, device: DeviceLike = None, group=None):
    """infer(G, P, vgg, gt, mask, ref) -> (fake_B, fake_P), NHWC f32 on
    `device`.  gt/ref: [B,H,W,3] uint8 (or [-1,1] f32), numpy or tensor;
    mask [B,H,W] (uint8 0/1, or f32).  The networks must already be on
    `device` and in eval mode (init_params returns them so).  With a Grid
    (parallel/spatial.py::make_sp_inference_fn) gt, mask and ref are this
    rank's slabs of rows, and so are fake_B and fake_P."""
    dev = resolve_device(device)
    return torch.inference_mode()(
        _inference_body(cfg, dev, as_grid(group)))


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """tensor2im quantization: floor(clip((x+1)*127.5, 0, 255))."""
    return torch.floor(torch.clamp((x + 1.0) * 127.5, 0.0, 255.0)
                       ).to(torch.uint8)


def serving_body(cfg: Config, device: DeviceLike = None, group=None):
    """The body of make_serving_fn, with no grad-mode context of its own:
    make_serving_fn runs it under inference_mode, and
    engine/export_model.py traces it under no_grad."""
    grid = as_grid(group)
    infer = _inference_body(cfg, resolve_device(device), grid)

    def serve_fn(G, P, vgg, gt, mask, ref):
        fake_B, _ = infer(G, P, vgg, gt, mask, ref)
        with use_grid(grid):
            return full_rows(to_uint8(fake_B), dim=1)

    return serve_fn


def make_serving_fn(cfg: Config, device: DeviceLike = None, group=None):
    """serve(G, P, vgg, gt, mask, ref) -> uint8 [B,H,W,3] on `device`;
    the quantization runs on the device, so 1 byte/px crosses to the
    host.  With a Grid the inputs are this rank's slabs and the uint8
    image comes back whole (gathered) on every rank."""
    return torch.inference_mode()(serving_body(cfg, device, group))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _mean_over(group, tensors):
    """`tensors` in one process (group None); in a group, each one's mean
    over the ranks, through one all-reduce of one flat buffer."""
    tensors = list(tensors)
    return tensors if group is None else all_reduce_mean(tensors, group)


def _global_metrics(group, metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The metrics detached, and in a group their means over the ranks."""
    return dict(zip(metrics, _mean_over(
        group, (v.detach() for v in metrics.values()))))


def _apply_grads(opt: torch.optim.Optimizer, params, grads) -> None:
    with span("dip.step.optimiser"):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()


def _batch_inputs(cfg: Config, batch, dev: torch.device):
    """A train batch on `dev`: (gt, ref) NCHW in [-1, 1], mask [B,H,W],
    feat_mask and flag."""
    with span("dip.step.inputs"):
        gt = normalize_image(_as_tensor(batch["image"], dev)).permute(
            0, 3, 1, 2)
        ref = normalize_image(_as_tensor(batch["ref"], dev)).permute(
            0, 3, 1, 2)
        mask, fmask, flag = _masks(cfg, _as_tensor(batch["mask"], dev))
    return gt, ref, mask, fmask, flag


def _d_losses(cfg: Config, D, F, fake_B, gt, fake_feat, real_feat):
    """The D/F phase's losses on the detached fake_B: D runs fake then
    real, the order its BatchNorm statistics chain in."""
    loss_D_img = ra_gan_loss(D(fake_B), D(gt), True, cfg.gan_type)
    loss_F_feat = ra_gan_loss(F(fake_feat), F(real_feat), True, cfg.gan_type)
    return loss_D_img, loss_F_feat


def _g_losses(cfg: Config, D, F, fwd: ForwardOut, gt, fake_feat, vgg_gt,
              fmask):
    """The G/P phase's losses against the (updated) discriminators:
    (loss_G, G_GAN, G_L1, cosis).  D on the real image and the whole
    feature branch (VGG of the detached fake_B) are constants with respect
    to G and P, so they run without a graph; autograd.grad on G's and P's
    parameters alone leaves no gradient on D and F.  D still runs fake then
    real."""
    pred_fake = D(fwd.fake_B)
    with torch.no_grad():
        pred_real = D(gt)
        loss_G_feat = ra_gan_loss(F(fake_feat), F(vgg_gt.relu3_3), False,
                                  cfg.gan_type)
    loss_G_GAN = ra_gan_loss(pred_fake, pred_real, False,
                             cfg.gan_type) + loss_G_feat
    loss_G_L1 = (l1_loss(fwd.fake_B, gt)
                 + l1_loss(fwd.fake_P, gt)) * cfg.lambda_A
    loss_G = loss_G_L1 + loss_G_GAN * cfg.gan_weight
    cos = torch.zeros((), device=gt.device)
    if cfg.cosis and not cfg.skip:
        cos = (inner_cos_loss(fwd.taps["inner_cos"], fmask, vgg_gt.relu4_3,
                              cfg.strength)
               + inner_cos_loss(fwd.taps["inner_cos2"], fmask,
                                vgg_gt.relu4_3, cfg.strength))
        if cfg.faithful_detached_cosis:
            cos = cos.detach()
        loss_G = loss_G + cos
    return loss_G, loss_G_GAN, loss_G_L1, cos


def make_train_step(cfg: Config, device: DeviceLike = None, group=None):
    """train_step(state, batch, generator=None) -> (state, metrics): one
    optimisation step of all four networks, D and F first, then G and P
    against the updated discriminators.  With a torch.distributed `group`
    the step is one rank's share of the step on the global batch (batch
    holds the rank's rows; parallel/mesh.py::make_dp_train_step); with a
    Grid, its rows' slab (parallel/spatial.py::make_dp_sp_train_step).

    batch: {'image', 'ref'}: [B,H,W,3] uint8 (or [-1,1] f32), 'mask':
    [B,H,W] (uint8 0/1, or f32), numpy or tensors.  `generator` (on
    `device`) feeds the dropout when cfg.use_dropout.  The state's
    networks and optimisers are updated in place and the same state comes
    back with step + 1; each parameter's `.grad` holds the gradient the
    step applied.  metrics: 0-dim f32 tensors on `device` — G_GAN, G_L1, D,
    F, cosis, and loss (= G_L1).  cfg.debug_nan is the trainer's to honour
    (engine/trainer.py); the step itself ignores it, as the JAX package's
    does.  cfg.dtype and cfg.remat apply through two_stage_forward and the
    U-Nets; cfg.grad_accum > 1 gives _make_accum_train_step's step.
    """
    dev = resolve_device(device)
    check_train_config(cfg)
    impl = check_impl(cfg.attention_impl)
    dt = compute_dtype(cfg)
    grid = as_grid(group)
    if cfg.grad_accum > 1:
        return _make_accum_train_step(cfg, dev, impl, dt, grid)
    world = None if grid is None else grid.world

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        with span("dip.step"), conv_modes(cfg), use_grid(grid):
            return _train_step(state, batch, generator)

    def _train_step(state: TrainState, batch,
                    generator: Optional[torch.Generator]):
        G, P, D, F, vgg = state.G, state.P, state.D, state.F, state.vgg
        for net in (G, P, D, F):
            net.train()
        gt, ref, mask, fmask, flag = _batch_inputs(cfg, batch, dev)
        with span("dip.step.forward"):
            with torch.no_grad():
                vgg_ref = vgg(ref)
                vgg_gt = vgg(gt)
            # One forward for the whole step: the D phase sees the detached
            # fake_B, the G phase differentiates through this same graph.
            fwd = two_stage_forward(G, P, gt, mask, vgg_ref.relu4_3, flag,
                                    impl, generator, dt)
            fake_B_const = fwd.fake_B.detach()
            with torch.no_grad():
                # only relu3_3 of the fake image is consumed (netF's input)
                fake_feat = vgg(fake_B_const, upto=3).relu3_3

        # ---- D / F phase ----
        with span("dip.step.d_phase"):
            loss_D_img, loss_F_feat = _d_losses(cfg, D, F, fake_B_const, gt,
                                                fake_feat, vgg_gt.relu3_3)
            params_D, params_F = list(D.parameters()), list(F.parameters())
            # autograd.grad frees the D-phase graph, so the in-place
            # optimiser steps below invalidate no tensor saved for a later
            # backward.
            grads = _mean_over(world, torch.autograd.grad(
                0.5 * loss_D_img + 0.5 * loss_F_feat, params_D + params_F))
        _apply_grads(state.opt_D, params_D, grads[:len(params_D)])
        _apply_grads(state.opt_F, params_F, grads[len(params_D):])

        # ---- G / P phase, against the updated discriminators ----
        with span("dip.step.g_phase"):
            loss_G, loss_G_GAN, loss_G_L1, cos = _g_losses(
                cfg, D, F, fwd, gt, fake_feat, vgg_gt, fmask)
            params_G, params_P = list(G.parameters()), list(P.parameters())
            grads = _mean_over(world, torch.autograd.grad(
                loss_G, params_G + params_P))
        _apply_grads(state.opt_G, params_G, grads[:len(params_G)])
        _apply_grads(state.opt_P, params_P, grads[len(params_G):])

        state.step += 1
        metrics = {"G_GAN": loss_G_GAN, "G_L1": loss_G_L1, "D": loss_D_img,
                   "F": loss_F_feat, "cosis": cos, "loss": loss_G_L1}
        return state, _global_metrics(world, metrics)

    return train_step


def _dropout_generator(dev: torch.device,
                       generator: Optional[torch.Generator]
                       ) -> torch.Generator:
    """The generator the dropout draws from: `generator`, or the device's
    default one when it is None."""
    if generator is not None:
        return generator
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


def _accumulate(acc, grads):
    if acc is None:
        return list(grads)
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


def _make_accum_train_step(cfg: Config, dev: torch.device, impl: str,
                           dt: torch.dtype, grid):
    """The gradient-accumulated train step (cfg.grad_accum = k > 1), as the
    JAX package's _make_accum_train_step states it: the batch splits into
    k microbatches, and only one microbatch's activations live at a time.

      D phase  for each microbatch: VGG of gt to relu3_3, a train-mode
               forward without a graph (so the attention takes its kbar-free
               primal), D fake then real; the D and F gradients are summed,
               divided by k, and D and F step.
      G phase  each microbatch's forward again, with the dropout draw of
               its D-phase forward, against the updated D and F; the G and
               P gradients are summed, divided by k, and G and P step.
    The metrics are the means over the microbatches (D and F from the D
    phase, the rest from the G phase).  With norm='batch' G's and P's
    running statistics move in the D phase only (the G phase's forwards
    repeat those, under frozen_running_stats), and D's chain fake -> real
    per microbatch in the D phase and twice more per microbatch in the G
    phase.  The relativistic GAN losses take batch means inside, so the
    step is not the same function as one step on the whole batch.

    In a group each rank's batch holds its share of every global
    microbatch in order (parallel/mesh.py::process_batch_rows), so chunk i
    of it is the rank's rows of microbatch i, and the relativistic means
    and BatchNorm moments of each microbatch are the global microbatch's.
    """
    k = cfg.grad_accum
    world = None if grid is None else grid.world

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        with span("dip.step"), conv_modes(cfg), use_grid(grid):
            return _train_step(state, batch, generator)

    def _train_step(state: TrainState, batch,
                    generator: Optional[torch.Generator]):
        G, P, D, F, vgg = state.G, state.P, state.D, state.F, state.vgg
        for net in (G, P, D, F):
            net.train()
        inputs = _batch_inputs(cfg, batch, dev)
        b = inputs[0].shape[0]
        if b % k:
            raise ValueError(
                f"batch_size {b} is not divisible by grad_accum {k}")
        micro = list(zip(*(t.chunk(k) for t in inputs)))
        gen = _dropout_generator(dev, generator)
        draws = []

        # ---- D / F phase, against the discriminators before the step ----
        params_D, params_F = list(D.parameters()), list(F.parameters())
        acc, loss_D_img, loss_F_feat = None, 0.0, 0.0
        with span("dip.step.d_phase"):
            for gt, ref, mask, _, flag in micro:
                with span("dip.step.forward"), torch.no_grad():
                    real_feat = vgg(gt, upto=3).relu3_3
                    ref_feat = vgg(ref).relu4_3
                    draws.append(gen.get_state())
                    fwd = two_stage_forward(G, P, gt, mask, ref_feat, flag,
                                            impl, generator, dt)
                    fake_feat = vgg(fwd.fake_B, upto=3).relu3_3
                l_D, l_F = _d_losses(cfg, D, F, fwd.fake_B, gt, fake_feat,
                                     real_feat)
                acc = _accumulate(acc, torch.autograd.grad(
                    0.5 * l_D + 0.5 * l_F, params_D + params_F))
                loss_D_img = loss_D_img + l_D.detach()
                loss_F_feat = loss_F_feat + l_F.detach()
            for g in acc:
                g.div_(k)
            acc = _mean_over(world, acc)
        _apply_grads(state.opt_D, params_D, acc[:len(params_D)])
        _apply_grads(state.opt_F, params_F, acc[len(params_D):])

        # ---- G / P phase, against the updated discriminators ----
        params_G, params_P = list(G.parameters()), list(P.parameters())
        acc, sums = None, [0.0, 0.0, 0.0]
        with span("dip.step.g_phase"):
            for (gt, ref, mask, fmask, flag), draw in zip(micro, draws):
                with span("dip.step.forward"):
                    with torch.no_grad():
                        vgg_gt = vgg(gt)
                        ref_feat = vgg(ref).relu4_3
                    gen.set_state(draw)
                    with frozen_running_stats(G, P):
                        fwd = two_stage_forward(G, P, gt, mask, ref_feat,
                                                flag, impl, generator, dt)
                    with torch.no_grad():
                        fake_feat = vgg(fwd.fake_B.detach(), upto=3).relu3_3
                loss_G, *parts = _g_losses(cfg, D, F, fwd, gt, fake_feat,
                                           vgg_gt, fmask)
                acc = _accumulate(acc, torch.autograd.grad(
                    loss_G, params_G + params_P))
                sums = [s + v.detach() for s, v in zip(sums, parts)]
            for g in acc:
                g.div_(k)
            acc = _mean_over(world, acc)
        _apply_grads(state.opt_G, params_G, acc[:len(params_G)])
        _apply_grads(state.opt_P, params_P, acc[len(params_G):])

        state.step += 1
        loss_G_GAN, loss_G_L1, cos = (v / k for v in sums)
        metrics = {"G_GAN": loss_G_GAN, "G_L1": loss_G_L1,
                   "D": loss_D_img / k, "F": loss_F_feat / k, "cosis": cos,
                   "loss": loss_G_L1}
        return state, _global_metrics(world, metrics)

    return train_step


# ---------------------------------------------------------------------------
# eval step and the coarse stage
# ---------------------------------------------------------------------------

def make_eval_step(cfg: Config, device: DeviceLike = None, group=None):
    """eval_step(state, batch) -> dict: the reference's model.test(), a
    deterministic forward with the validation losses and per-image metrics.

    `state` holds G, P and vgg (a TrainState or Models) on `device`; G and
    P run in eval mode and come back in the mode they had.  batch as
    make_train_step takes it.  Returns, on `device`:
      fake_B, fake_P   [B,H,W,3] f32 (NHWC)
      loss_ipsr        ra_gan_loss(gt, fake_B, False): the reference calls
                       its GAN criterion with the images in place of
                       discriminator predictions, and so does this
      loss_valid       (L1(fake_B, gt) + L1(fake_P, gt)) * lambda_A
      psnr, ssim       [B], per image (utils/metrics.py)
      visuals          real_A (the zero-holed input), real_Ref, fake_B,
                       fake_P, real_B, each [B,H,W,3]
    The eval forward builds no attention matrix: one scan launch a call on
    the card, no kbar.  With a torch.distributed `group` (parallel/mesh.py
    ::make_dp_eval_step) batch holds the rank's rows: the images and the
    per-image metrics are the rank's, loss_ipsr and loss_valid the global
    batch's.  With a Grid (parallel/spatial.py::make_dp_sp_eval_step) the
    batch holds its rows' slab, and the images come back whole (gathered:
    SSIM's windows cross the slabs), the same on each rank of the sp group.
    """
    from ..utils.metrics import psnr, ssim
    dev = resolve_device(device)
    check_config(cfg)
    impl = check_impl(cfg.attention_impl)
    dt = compute_dtype(cfg)
    grid = as_grid(group)
    world = None if grid is None else grid.world

    @torch.inference_mode()
    def eval_step(state, batch) -> Dict[str, object]:
        with use_grid(grid):
            return _eval_step(state, batch)

    def _eval_step(state, batch) -> Dict[str, object]:
        G, P, vgg = state.G, state.P, state.vgg
        modes = (G.training, P.training)
        G.eval()
        P.eval()
        try:
            gt = normalize_image(_as_tensor(batch["image"], dev)
                                 ).permute(0, 3, 1, 2)
            ref = normalize_image(_as_tensor(batch["ref"], dev)
                                  ).permute(0, 3, 1, 2)
            mask, _, flag = _masks(cfg, _as_tensor(batch["mask"], dev))
            with conv_modes(cfg):
                fwd = two_stage_forward(G, P, gt, mask, vgg(ref).relu4_3,
                                        flag, impl, dtype=dt)
        finally:
            G.train(modes[0])
            P.train(modes[1])
        fake_B, fake_P, known, gt, ref = (
            full_rows(t) for t in (fwd.fake_B, fwd.fake_P, fwd.known, gt,
                                   ref))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        with replicated():
            losses = _global_metrics(world, {
                "loss_ipsr": ra_gan_loss(gt, fake_B, False, cfg.gan_type),
                "loss_valid": (l1_loss(fake_B, gt)
                               + l1_loss(fake_P, gt)) * cfg.lambda_A})
        return {
            "fake_B": nhwc(fake_B), "fake_P": nhwc(fake_P),
            **losses,
            "psnr": psnr(gt, fake_B), "ssim": ssim(gt, fake_B),
            "visuals": {"real_A": nhwc(known), "real_Ref": nhwc(ref),
                        "fake_B": nhwc(fake_B),
                        "fake_P": nhwc(fake_P), "real_B": nhwc(gt)},
        }

    return eval_step


def make_coarse_fn(cfg: Config, device: DeviceLike = None):
    """coarse(P, gt, mask) -> (fake_P, composite), NHWC f32 on `device`:
    netP alone on the mean-filled image, and its output pasted into the
    hole.  gt and mask as make_inference_fn takes them; P must be on
    `device` in eval mode."""
    dev = resolve_device(device)
    check_config(cfg)
    dt = compute_dtype(cfg)

    @torch.inference_mode()
    def coarse(P, gt, mask):
        gt = normalize_image(_as_tensor(gt, dev)).permute(0, 3, 1, 2)
        mask = resolve_mask(cfg, normalize_mask(_as_tensor(mask, dev)))
        with conv_modes(cfg):
            fake_P = P(M.fill_hole_with_mean(gt, mask).to(dt)
                       ).to(torch.float32)
        m = mask[:, None]
        composite = fake_P * m + gt * (1.0 - m)
        return fake_P.permute(0, 2, 3, 1), composite.permute(0, 2, 3, 1)

    return coarse
