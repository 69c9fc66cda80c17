"""Plain PyTorch reference of the inpainting networks, written apart from
the program under test and frozen with the benchmark.

Every network is a function of a flat parameter dict whose keys are the
program's state_dict keys (the interchange format of the weights, not code
of the program): netP (`unet_256`), netG (`unet_ipsr` with the IPSR shift
attention), VGG16 to relu4_3, netD (PatchGAN, 3 layers) and netF (the
feature PatchGAN).  The structure is worked out from the keys and the
image size.  NCHW throughout.

Arithmetic, as the configuration states it:
  * compute dtype: a conv or transposed conv takes its input's dtype; its
    weight is cast to that dtype and, outside f32, the bias is added after
    the conv in that dtype.  Instance norm keeps its statistics in f32 and
    applies its scale and offset in the input's dtype.
  * the attention computes in f32 and returns the feature's dtype.  Its
    coherence scan accumulates each dot product in f64 and rounds it once
    to f32; the attention matrix's rows are three separately rounded f32
    operations a step.  Its backward is g + triple_weight * trunc(K)^T g
    (the reference quirk: the matrix is stored into an integer tensor).
  * `Precision.fp8_operands` rounds every conv operand (activation and
    weight) to float8 e4m3 with a per-tensor scale before the conv, a
    forward-only rounding (the gradient passes straight through).  It
    exists for the control of the correctness check and is off otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_NORM_EPS = 1e-8
_IN_EPS = 1e-5
_FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    """How the reference rounds: `dtype` is netP's and netG's activation
    dtype; `fp8_operands` rounds conv operands to e4m3 (the control)."""
    dtype: torch.dtype = torch.float32
    fp8_operands: bool = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    back in x's dtype; the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / _FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def conv(x, w, b, prec: Precision, stride=1, padding=0, dilation=1,
         transpose=False):
    """Conv2d / ConvTranspose2d (output_padding 0) in x's dtype; the bias
    fused in f32, added after the conv in another dtype."""
    wq = w.to(x.dtype)
    if prec.fp8_operands:
        x, wq = _fp8(x), _fp8(wq)
    fused = b if x.dtype == torch.float32 else None
    if transpose:
        y = F.conv_transpose2d(x, wq, fused, stride, padding)
    else:
        y = F.conv2d(x, wq, fused, stride, padding, dilation)
    if b is None or fused is not None:
        return y
    return y + b.to(y.dtype)[:, None, None]


def inorm(x, weight, bias):
    """InstanceNorm2d(affine=True), biased variance, statistics in f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + _IN_EPS)).to(x.dtype)
    return (y * weight.to(y.dtype)[:, None, None]
            + bias.to(y.dtype)[:, None, None])


def _resize_to(y, x):
    """Bilinear (half-pixel, antialiased) resize of y to x's size where a
    skip's sizes differ."""
    if y.shape[2:] == x.shape[2:]:
        return y
    return F.interpolate(y, size=x.shape[2:], mode="bilinear",
                         align_corners=False, antialias=True)


def _levels(params: Params, head: str = "model."):
    """The U-Net's level prefixes from the outermost in."""
    out, prefix = [], head
    while any(k.startswith(prefix) for k in params):
        out.append(prefix)
        prefix += "submodule."
    return out


# ---- netP: unet_256 ---------------------------------------------------------

def net_p(p: Params, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Rough U-Net: down = LeakyReLU -> Conv4x4 s2 p1 -> IN, up = ReLU ->
    ConvT4x4 s2 p1 -> IN, the outermost level ends in tanh, skips are
    [up, x] concats."""
    levels = _levels(p)

    def level(i, x):
        k = levels[i]
        outer, inner = i == 0, i == len(levels) - 1
        y = x if outer else F.leaky_relu(x, 0.2)
        y = conv(y, p[k + "down_conv.weight"], p[k + "down_conv.bias"],
                 prec, 2, 1)
        if not (outer or inner):
            y = inorm(y, p[k + "down_norm.weight"], p[k + "down_norm.bias"])
        if not inner:
            y = level(i + 1, y)
        y = conv(F.relu(y), p[k + "up_conv.weight"], p[k + "up_conv.bias"],
                 prec, 2, 1, transpose=True)
        if outer:
            return torch.tanh(y)
        y = inorm(y, p[k + "up_norm.weight"], p[k + "up_norm.bias"])
        return torch.cat([_resize_to(y, x), x], dim=1)

    return level(0, x)


# ---- the IPSR shift attention -----------------------------------------------

def attention_prep(feat_rows: torch.Tensor, ref_rows: torch.Tensor):
    """[B, N, C] rows -> (P, Pn, ind, vmax, known), f32.  Faithful known
    replacement: every position takes its best-matching patch."""
    P = feat_rows.float()
    R = ref_rows.float()
    Pn = P * (1.0 / (torch.linalg.vector_norm(P, dim=2, keepdim=True)
                     + _NORM_EPS))
    scores = torch.bmm(Pn, R.transpose(1, 2))          # [B, patch, pos]
    ind = torch.argmax(scores, dim=1)
    vmax = torch.amax(scores, dim=1)
    known = torch.gather(P, 1, ind[:, :, None].expand(-1, -1, P.shape[2]))
    return P, Pn, ind, vmax, known


def coherence_scan(flag, vmax, pn, known):
    """The raster-order coherence recurrence over positions q:
    first masked q -> known_q, (a, b) = (0, 1); later masked q ->
    a*out_prev + b*known_q with at = <pn_q, out_prev> (f64 sum, one
    rounding), a = at/(at+vmax_q), b = vmax_q/(at+vmax_q); unmasked q ->
    known_q, (a, b) = (1, 0).  Returns (out [B,N,C], a [B,N], b [B,N])."""
    bsz, n, c = pn.shape
    out = torch.empty_like(known)
    a_all = torch.empty_like(vmax)
    b_all = torch.empty_like(vmax)
    carry = torch.zeros((bsz, c), dtype=pn.dtype, device=pn.device)
    seen = torch.zeros((bsz,), dtype=torch.bool, device=pn.device)
    zero = torch.zeros((), dtype=pn.dtype, device=pn.device)
    one = torch.ones((), dtype=pn.dtype, device=pn.device)
    for q in range(n):
        masked = flag[:, q] > 0
        first = masked & ~seen
        at = (pn[:, q].double() * carry.double()).sum(dim=1).float()
        denom = at + vmax[:, q]
        a = torch.where(first, zero, at / denom)
        b = torch.where(first, one, vmax[:, q] / denom)
        blend = a[:, None] * carry + b[:, None] * known[:, q]
        out[:, q] = torch.where(masked[:, None], blend, known[:, q])
        a_all[:, q] = torch.where(masked, a, one)
        b_all[:, q] = torch.where(masked, b, zero)
        carry = torch.where(masked[:, None], blend, carry)
        seen = seen | masked
    return out, a_all, b_all


def attention_matrix(flag, ind, a, b):
    """Row q of the attention matrix: a_q*row_prev + b_q*onehot(ind_q) on
    masked q (the row carry advances), onehot(ind_q) on unmasked q.  Two
    products and a sum, each rounded.  Returns [B, N, N] f32."""
    bsz, n = flag.shape
    kbar = torch.empty((bsz, n, n), dtype=torch.float32, device=flag.device)
    cols = torch.arange(n, device=flag.device)
    row = torch.zeros((bsz, n), dtype=torch.float32, device=flag.device)
    for q in range(n):
        onehot = (cols == ind[:, q, None]).float()
        row = a[:, q, None] * row + b[:, q, None] * onehot
        kbar[:, q] = torch.where(flag[:, q, None] > 0, row, onehot)
    return kbar


def _rows(t):
    return t.flatten(2).transpose(1, 2)


class _TrainAttention(torch.autograd.Function):
    """Training forward out = kbar @ P; backward g + tw * trunc(kbar)^T g."""

    @staticmethod
    def forward(ctx, feat, ref, flag, triple_weight):
        bsz, c, h, w = feat.shape
        P, Pn, ind, vmax, known = attention_prep(_rows(feat), _rows(ref))
        _, a, b = coherence_scan(flag, vmax, Pn, known)
        kbar = attention_matrix(flag, ind, a, b)
        ctx.save_for_backward(torch.trunc(kbar))
        ctx.triple_weight = triple_weight
        out = torch.bmm(kbar, P)
        return out.transpose(1, 2).reshape(bsz, c, h, w).to(feat.dtype)

    @staticmethod
    def backward(ctx, g):
        K, = ctx.saved_tensors
        extra = torch.bmm(g.flatten(2).float(), K)
        return g + ctx.triple_weight * extra.reshape(g.shape).to(g.dtype), \
            None, None, None


def attention(feat, ref, flag, triple_weight: float = 1.0):
    """IPSR attention on NCHW feat/ref, flag [B, N] (1 = masked).  Under
    grad: the training forward and its backward; otherwise the scan's
    output."""
    if torch.is_grad_enabled() and feat.requires_grad:
        return _TrainAttention.apply(feat, ref, flag, triple_weight)
    bsz, c, h, w = feat.shape
    _, Pn, _, vmax, known = attention_prep(_rows(feat), _rows(ref))
    out, _, _ = coherence_scan(flag, vmax, Pn, known)
    return out.transpose(1, 2).reshape(bsz, c, h, w).to(feat.dtype)


# ---- netG: unet_ipsr --------------------------------------------------------

ATTENTION_LEVEL = 3      # 256 -> 128 -> 64 -> 32: the ngf*4 -> ngf*8 level


def net_g(p: Params, x, ref_feat, flag, prec: Precision,
          triple_weight: float = 1.0
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Refinement U-Net with the attention level and the InnerCos taps.
    x [B,6,H,W], ref_feat [B,8ngf,H/8,W/8] in the compute dtype.  Returns
    (out, {'inner_cos', 'inner_cos2'})."""
    levels = _levels(p)
    taps: Dict[str, torch.Tensor] = {}

    def level(i, x):
        k = levels[i]
        outer, inner = i == 0, i == len(levels) - 1
        attn = i == ATTENTION_LEVEL
        if outer:
            y = conv(x, p[k + "down_conv3.weight"], p[k + "down_conv3.bias"],
                     prec, 1, 1)
        else:
            y = conv(F.leaky_relu(x, 0.2), p[k + "down_dilconv.weight"],
                     p[k + "down_dilconv.bias"], prec, 2, 3, 2)
            if not inner:
                y = inorm(y, p[k + "down_norm.weight"],
                          p[k + "down_norm.bias"])
                y = conv(F.leaky_relu(y, 0.2), p[k + "down_conv3.weight"],
                         p[k + "down_conv3.bias"], prec, 1, 1)
                if attn:
                    y = attention(y, ref_feat.to(y.dtype), flag,
                                  triple_weight)
                    taps["inner_cos"] = y
                y = inorm(y, p[k + "down_norm3.weight"],
                          p[k + "down_norm3.bias"])
        if not inner:
            y = level(i + 1, y)
        if outer:
            return conv(F.relu(y), p[k + "up_conv3.weight"],
                        p[k + "up_conv3.bias"], prec, 1, 1, transpose=True)
        if not inner:
            if attn:
                inner_nc = p[k + "down_conv3.weight"].shape[0]
                taps["inner_cos2"] = y[:, :inner_nc]
            y = conv(F.relu(y), p[k + "up_conv3.weight"],
                     p[k + "up_conv3.bias"], prec, 1, 1, transpose=True)
            y = inorm(y, p[k + "up_norm3.weight"], p[k + "up_norm3.bias"])
        y = conv(F.relu(y), p[k + "up_conv.weight"], p[k + "up_conv.bias"],
                 prec, 2, 1, transpose=True)
        y = inorm(y, p[k + "up_norm.weight"], p[k + "up_norm.bias"])
        return torch.cat([_resize_to(y, x), x], dim=1)

    out = level(0, x)
    return out, taps


# ---- VGG16 to relu4_3 -------------------------------------------------------

VGG_SLICES = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2"),
              ("conv3_1", "conv3_2", "conv3_3"),
              ("conv4_1", "conv4_2", "conv4_3"))


def vgg(p: Params, x, prec: Precision, upto: int = 4):
    """[relu1_2, relu2_2, relu3_3, relu4_3] (the first three after their
    max-pool), the later entries None when upto < 4."""
    feats = []
    y = x
    for si, names in enumerate(VGG_SLICES):
        if si >= upto:
            feats.append(None)
            continue
        for name in names:
            y = F.relu(conv(y, p[name + ".weight"], p[name + ".bias"], prec,
                            1, 1))
        if si < 3:
            y = F.max_pool2d(y, 2)
        feats.append(y)
    return feats


# ---- the discriminators -----------------------------------------------------

def net_d(p: Params, x, prec: Precision):
    """PatchGAN: conv0 s2 -> LReLU; conv1, conv2 s2 and conv3 s1, each ->
    IN -> LReLU; a k4 s1 head."""
    y = F.leaky_relu(conv(x, p["conv0.weight"], p["conv0.bias"], prec, 2, 1),
                     0.2)
    n = 1
    while f"conv{n}.weight" in p:
        stride = 2 if f"conv{n + 1}.weight" in p else 1
        y = conv(y, p[f"conv{n}.weight"], p.get(f"conv{n}.bias"), prec,
                 stride, 1)
        y = F.leaky_relu(inorm(y, p[f"norm{n}.weight"], p[f"norm{n}.bias"]),
                         0.2)
        n += 1
    return conv(y, p["head.weight"], p["head.bias"], prec, 1, 1)


def net_f(p: Params, x, prec: Precision):
    """Feature PatchGAN on relu3_3: three k4 s2 p1 convs, the middle one
    followed by an instance norm without affine parameters; maps under
    8x8 are zero-padded at the bottom and right."""
    pad_h, pad_w = max(0, 8 - x.shape[2]), max(0, 8 - x.shape[3])
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h))
    y = F.leaky_relu(conv(x, p["conv0.weight"], p["conv0.bias"], prec, 2, 1),
                     0.2)
    y = conv(y, p["conv1.weight"], p["conv1.bias"], prec, 2, 1)
    mean = y.mean(dim=(2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (y - mean) / torch.sqrt(var + _IN_EPS)
    return conv(F.leaky_relu(y, 0.2), p["conv2.weight"], p["conv2.bias"],
                prec, 2, 1)
