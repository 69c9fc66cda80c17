"""Plain PyTorch reference of the two-stage inference and of the GAN train
step, over the networks of nets.py, frozen with the benchmark.

  masks      feature mask: three 4x4 s2 p1 window sums / 16 of the hole
             mask, then > threshold; flags: the feature mask >= mask_thred
             (1x1 patches, stride 1), raster order
  inference  netP on the image with its hole filled by the ImageNet-mean
             constants; syn = fake_P in the hole, the image outside; netG on
             [syn, zero-holed image] with VGG relu4_3 of the reference
             image; uint8 = floor(clip((fake_B + 1) * 127.5, 0, 255))
  train step VGG of the reference and of the image (no grad); one forward;
             D and F step on the detached fake_B (relativistic LSGAN, half
             each), then G and P against the updated D and F: L1 of both
             stages * lambda_A + (image GAN + feature GAN) * gan_weight +
             the InnerCos losses, detached; Adam (lr, (beta1, 0.999), 1e-8)
             on every network

Weights are dicts {'G', 'P', 'D', 'F', 'vgg'} of flat parameter dicts.
Nothing here depends on the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import nets
from .nets import Precision

HOLE_FILL_RGB = (2 * 123.0 / 255.0 - 1.0, 2 * 104.0 / 255.0 - 1.0,
                 2 * 117.0 / 255.0 - 1.0)
TRAINED = ("G", "P", "D", "F")


def feature_flags(mask: torch.Tensor, threshold: float, mask_thred: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [B,H,W] f32, 1 = hole -> (feature mask [B,H/8,W/8], flags
    [B,(H/8)*(W/8)])."""
    x = mask.float()[:, None]
    for _ in range(3):
        x = F.avg_pool2d(x, 4, 2, 1, divisor_override=1) * (1.0 / 16.0)
    fmask = (x[:, 0] > threshold).float()
    return fmask, (fmask >= mask_thred).float().flatten(1)


def to_inputs(image_u8, mask_u8, ref_u8, device):
    """uint8 NHWC image and reference, uint8 [B,H,W] mask -> ([-1,1] NCHW
    image, mask f32 (m > 0), [-1,1] NCHW reference) on `device`."""
    def img(a):
        t = torch.as_tensor(a, device=device).float() / 127.5 - 1.0
        return t.permute(0, 3, 1, 2)
    mask = (torch.as_tensor(mask_u8, device=device) > 0).float()
    return img(image_u8), mask, img(ref_u8)


def two_stage(w, gt, mask, ref_feat, flag, cfg, prec: Precision):
    """(fake_P, fake_B, taps), all f32, from gt [B,3,H,W] in [-1,1]."""
    m = mask[:, None]
    fill = torch.tensor(HOLE_FILL_RGB, device=gt.device)[:, None, None]
    masked_mean = gt * (1.0 - m) + fill * m
    fake_P = nets.net_p(w["P"], masked_mean.to(prec.dtype), prec).float()
    known = gt * (1.0 - m)
    syn = fake_P.detach() * m + known
    middle = torch.cat([syn, known], dim=1)
    fake_B, taps = nets.net_g(w["G"], middle.to(prec.dtype),
                              ref_feat.to(prec.dtype), flag, prec,
                              cfg["triple_weight"])
    return fake_P, fake_B.float(), {k: v.float() for k, v in taps.items()}


@torch.no_grad()
def serve(w, image_u8, mask_u8, ref_u8, cfg, prec: Precision, device):
    """The uint8 answers [B,H,W,3] (on `device`) to a batch of requests."""
    gt, mask, ref = to_inputs(image_u8, mask_u8, ref_u8, device)
    _, flag = feature_flags(mask, cfg["threshold"], cfg["mask_thred"])
    ref_feat = nets.vgg(w["vgg"], ref.to(prec.dtype), prec)[3]
    _, fake_B, _ = two_stage(w, gt, mask, ref_feat, flag, cfg, prec)
    u8 = torch.floor(torch.clamp((fake_B + 1.0) * 127.5, 0.0, 255.0))
    return u8.to(torch.uint8).permute(0, 2, 3, 1)


def ra_lsgan(pred_fake, pred_real, discriminator: bool):
    """Relativistic-average LSGAN: the discriminator's direction pushes
    real - mean(fake) to 1 and fake - mean(real) to -1, the generator's the
    other way round."""
    real_rel = pred_real - pred_fake.mean()
    fake_rel = pred_fake - pred_real.mean()
    t = 1.0 if discriminator else -1.0
    return 0.5 * ((real_rel - t).square().mean()
                  + (fake_rel + t).square().mean())


def inner_cos(feat, fmask, target, strength):
    return ((feat * fmask[:, None] * strength - target).square()).mean()


class Adam:
    """Adam with bias-corrected moments: p -= lr * m_hat / (sqrt(v_hat) +
    eps), per leaf."""

    def __init__(self, lr: float, beta1: float, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m.get(k)
                m = (1 - self.b1) * g if m is None else \
                    self.b1 * m + (1 - self.b1) * g
                v = self.v.get(k)
                v = (1 - self.b2) * g * g if v is None else \
                    self.b2 * v + (1 - self.b2) * g * g
                self.m[k], self.v[k] = m, v
                params[k] -= self.lr * (m / c1) / (torch.sqrt(v / c2)
                                                   + self.eps)


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    return dict(zip(keys, grads))


class TrainReference:
    """The reference train step over its own copy of the weights.

    `weights` holds every network's initial tensors; they are cloned, so
    the caller's copy stays as it was.  `step(batch)` takes a uint8 batch
    {'image', 'mask', 'ref'} and returns the step's losses; the first
    step's gradients of every trained leaf stay in `first_grads`."""

    def __init__(self, weights, cfg: dict, prec: Precision, device):
        self.cfg, self.prec, self.device = cfg, prec, device
        self.w = {net: {k: t.detach().clone().float()
                        .requires_grad_(net in TRAINED)
                        for k, t in sd.items()} for net, sd in weights.items()}
        self.opt = {net: Adam(cfg["lr"], cfg["beta1"]) for net in TRAINED}
        self.first_grads: Dict[str, Dict[str, torch.Tensor]] = {}

    def step(self, batch) -> Dict[str, float]:
        cfg, prec, w = self.cfg, self.prec, self.w
        gt, mask, ref = to_inputs(batch["image"], batch["mask"], batch["ref"],
                                  self.device)
        fmask, flag = feature_flags(mask, cfg["threshold"], cfg["mask_thred"])
        f32 = Precision()       # VGG, D and F run in f32 in training
        with torch.no_grad():
            vgg_ref = nets.vgg(w["vgg"], ref, f32)
            vgg_gt = nets.vgg(w["vgg"], gt, f32)
        fake_P, fake_B, taps = two_stage(w, gt, mask, vgg_ref[3], flag, cfg,
                                         prec)
        fake_const = fake_B.detach()
        with torch.no_grad():
            fake_feat = nets.vgg(w["vgg"], fake_const, f32, upto=3)[2]

        # D and F on the detached fake_B
        loss_D = ra_lsgan(nets.net_d(w["D"], fake_const, f32),
                          nets.net_d(w["D"], gt, f32), True)
        loss_F = ra_lsgan(nets.net_f(w["F"], fake_feat, f32),
                          nets.net_f(w["F"], vgg_gt[2], f32), True)
        grads_d = _grads(0.5 * loss_D + 0.5 * loss_F,
                         {**{"D." + k: v for k, v in w["D"].items()},
                          **{"F." + k: v for k, v in w["F"].items()}})
        for net in ("D", "F"):
            g = {k[2:]: v for k, v in grads_d.items() if k[0] == net}
            self._keep_first(net, g)
            self.opt[net].step(w[net], g)

        # G and P against the updated D and F
        pred_fake = nets.net_d(w["D"], fake_B, f32)
        with torch.no_grad():
            pred_real = nets.net_d(w["D"], gt, f32)
            loss_G_feat = ra_lsgan(nets.net_f(w["F"], fake_feat, f32),
                                   nets.net_f(w["F"], vgg_gt[2], f32), False)
        loss_G_GAN = ra_lsgan(pred_fake, pred_real, False) + loss_G_feat
        l1 = lambda a: (a - gt).abs().mean()
        loss_G_L1 = (l1(fake_B) + l1(fake_P)) * cfg["lambda_A"]
        cos = (inner_cos(taps["inner_cos"], fmask, vgg_gt[3], cfg["strength"])
               + inner_cos(taps["inner_cos2"], fmask, vgg_gt[3],
                           cfg["strength"])).detach()
        loss_G = loss_G_L1 + loss_G_GAN * cfg["gan_weight"] + cos
        grads_g = _grads(loss_G, {**{"G." + k: v for k, v in w["G"].items()},
                                  **{"P." + k: v for k, v in w["P"].items()}})
        for net in ("G", "P"):
            g = {k[2:]: v for k, v in grads_g.items() if k[0] == net}
            self._keep_first(net, g)
            self.opt[net].step(w[net], g)
        return {k: float(v.detach()) for k, v in (
            ("G_GAN", loss_G_GAN), ("G_L1", loss_G_L1), ("D", loss_D),
            ("F", loss_F), ("cosis", cos))}

    def _keep_first(self, net: str, grads) -> None:
        if net not in self.first_grads:
            self.first_grads[net] = {k: g.detach().clone()
                                     for k, g in grads.items()}


def leaf_norms(tensors: Dict[str, Dict[str, torch.Tensor]]
               ) -> Dict[str, float]:
    """{'net.key': f64 L2 norm} of nested dicts of tensors."""
    keys, vals = [], []
    for net, sd in tensors.items():
        for k, t in sd.items():
            keys.append(f"{net}.{k}")
            vals.append(torch.linalg.vector_norm(t.detach().double()))
    if not vals:
        return {}
    return dict(zip(keys, torch.stack(vals).cpu().tolist()))


def config_dict(cfg) -> dict:
    """The fields of a configuration the reference reads, from a mapping
    or an object with attributes."""
    get = cfg.get if isinstance(cfg, dict) else lambda k: getattr(cfg, k)
    return {k: get(k) for k in ("threshold", "mask_thred", "triple_weight",
                                "lambda_A", "gan_weight", "strength", "lr",
                                "beta1")}


def check_supported(cfg) -> None:
    """Raise for a configuration outside what this reference states."""
    get = cfg.get if isinstance(cfg, dict) else lambda k: getattr(cfg, k)
    want = {"which_model_netG": "unet_ipsr", "which_model_netP": "unet_256",
            "which_model_netD": "basic", "which_model_netF": "feature",
            "norm": "instance", "gan_type": "lsgan", "use_dropout": False,
            "shift_sz": 1, "stride": 1, "mask_type": "random", "cosis": 1,
            "skip": 0, "faithful_backward_truncation": True,
            "faithful_detached_cosis": True,
            "faithful_known_replacement": True,
            "grad_accum": 1, "quant": "none", "fine_size": None}
    for k, v in want.items():
        if v is not None and get(k) != v:
            raise ValueError(f"the reference does not state {k}={get(k)!r}")
    if get("fine_size") < 64 or 2 ** int(math.log2(get("fine_size"))) != \
            get("fine_size"):
        raise ValueError("the reference states power-of-two sizes >= 64")


def losses_of(step_losses: List[Dict[str, float]], gan_weight: float
              ) -> List[Dict[str, float]]:
    """Each step's two differentiated objectives: the generators' (L1 +
    gan_weight * GAN) and the discriminators' (half D + half F).  The
    InnerCos metric enters the generators' loss detached: it trains
    nothing, and it spikes where the coherence scan amplifies its inputs'
    rounding, so it is no part of what is compared."""
    return [{"G": s["G_L1"] + gan_weight * s["G_GAN"],
             "DF": 0.5 * s["D"] + 0.5 * s["F"]} for s in step_losses]
