"""Refinement U-Net generator netG, `unet_ipsr`, with the IPSR attention
level and the InnerCos feature taps (counterpart of
deepinpainting_tpu/models/unet_ipsr.py), NCHW.

  * non-outermost down: LeakyReLU -> dilated Conv4x4 s2 p3 d2 (keeps
    channels) -> IN -> LeakyReLU -> Conv3x3 s1 p1 (expands) -> IN
  * non-outermost up: ReLU -> ConvT3x3 s1 p1 (halves the skip concat) ->
    IN -> ReLU -> ConvT4x4 s2 p1 -> IN
  * outermost: Conv3x3 s1 p1 in, ReLU -> ConvT3x3 s1 p1 out — no tanh and
    no downsample, so this level runs at full resolution
  * innermost: LeakyReLU -> dilated conv down; ReLU -> ConvT4x4 s2 -> IN up
  * at the ngf*4 level (32x32 for 256 inputs) the down path is
    [..., Conv3x3 256->512, IPSR attention, InnerCos tap, IN] and the up
    path starts with the InnerCos2 tap on the skip concat

Layer attribute names follow the JAX package's flax scope names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import ipsr_attention_batched
from ..ops.convs import InstanceNorm, bilinear_resize, leaky_relu


class UnetBlock3(nn.Module):
    """One level of the refinement U-Net (the IPSR block when
    with_attention=True)."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None,
                 outermost: bool = False, innermost: bool = False,
                 use_dropout: bool = False, with_attention: bool = False,
                 known_replacement: bool = True):
        super().__init__()
        input_nc = outer_nc if input_nc is None else input_nc
        self.inner_nc = inner_nc
        self.outermost, self.innermost = outermost, innermost
        self.with_attention = with_attention
        self.known_replacement = known_replacement
        if outermost:
            self.down_conv3 = nn.Conv2d(input_nc, inner_nc, 3, 1, 1)
        else:
            self.down_dilconv = nn.Conv2d(input_nc, input_nc, 4, 2, 3,
                                          dilation=2)
            if not innermost:
                self.down_norm = InstanceNorm(input_nc)
                self.down_conv3 = nn.Conv2d(input_nc, inner_nc, 3, 1, 1)
                self.down_norm3 = InstanceNorm(inner_nc)
        self.submodule = submodule
        if outermost:
            self.up_conv3 = nn.ConvTranspose2d(2 * inner_nc, outer_nc, 3, 1, 1)
        elif innermost:
            self.up_conv = nn.ConvTranspose2d(input_nc, outer_nc, 4, 2, 1)
            self.up_norm = InstanceNorm(outer_nc)
        else:
            self.up_conv3 = nn.ConvTranspose2d(2 * inner_nc, outer_nc, 3, 1, 1)
            self.up_norm3 = InstanceNorm(outer_nc)
            self.up_conv = nn.ConvTranspose2d(outer_nc, outer_nc, 4, 2, 1)
            self.up_norm = InstanceNorm(outer_nc)
        self.dropout = (nn.Dropout(0.5) if use_dropout and not outermost
                        else None)

    def forward(self, x: torch.Tensor, aux: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """aux carries {'ref_feat': [B,C,h,w], 'flag': [B,h*w],
        'impl': attention_impl} for the attention level; returns
        (output, taps) with the InnerCos features."""
        taps: Dict[str, torch.Tensor] = {}
        # ---- down ----
        if self.outermost:
            y = self.down_conv3(x)
        else:
            y = self.down_dilconv(leaky_relu(x, 0.2))
            if not self.innermost:
                y = self.down_conv3(leaky_relu(self.down_norm(y), 0.2))
                if self.with_attention:
                    y = ipsr_attention_batched(
                        y, aux["ref_feat"].to(y.dtype), aux["flag"],
                        known_replacement=self.known_replacement,
                        impl=aux.get("impl"))
                    taps["inner_cos"] = y   # InnerCos tap, pre-norm
                y = self.down_norm3(y)
        # ---- submodule ----
        if self.submodule is not None:
            y, sub_taps = self.submodule(y, aux)
            taps.update(sub_taps)
        # ---- up ----
        if self.outermost:
            return self.up_conv3(F.relu(y)), taps
        if self.innermost:
            y = self.up_norm(self.up_conv(F.relu(y)))
        else:
            if self.with_attention:
                taps["inner_cos2"] = y[:, :self.inner_nc]
            y = self.up_norm3(self.up_conv3(F.relu(y)))
            y = self.up_norm(self.up_conv(F.relu(y)))
        if self.dropout is not None:
            y = self.dropout(y)
        if y.shape[2:] != x.shape[2:]:
            y = bilinear_resize(y, x.shape[2], x.shape[3])
        return torch.cat([y, x], dim=1), taps


class UnetGeneratorIPSR(nn.Module):
    """`unet_ipsr` refinement generator.  Ladder for 256 inputs: 256
    (outermost, no downsample) -> 128 -> 64 -> 32 (attention, 8ngf ch) ->
    16 -> 8 -> 4 -> 2 -> 1."""

    def __init__(self, input_nc: int = 6, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64,
                 use_dropout: bool = False, known_replacement: bool = True):
        super().__init__()
        block = UnetBlock3(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetBlock3(ngf * 8, ngf * 8, submodule=block,
                               use_dropout=use_dropout)
        block = UnetBlock3(ngf * 8, ngf * 8, submodule=block,
                           use_dropout=use_dropout)
        block = UnetBlock3(ngf * 4, ngf * 8, submodule=block,
                           with_attention=True,
                           known_replacement=known_replacement)
        block = UnetBlock3(ngf * 2, ngf * 4, submodule=block)
        block = UnetBlock3(ngf, ngf * 2, submodule=block)
        self.model = UnetBlock3(output_nc, ngf, input_nc=input_nc,
                                submodule=block, outermost=True)

    def forward(self, x: torch.Tensor, ref_feat: torch.Tensor,
                flag: torch.Tensor, attention_impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: [B,6,H,W] (coarse composite ++ zero-holed input); ref_feat:
        [B,8ngf,H/8,W/8] VGG relu4_3 of the reference; flag [B,(H/8)*(W/8)].
        attention_impl: 'cuda' (default; also 'pallas') or 'torch' (also
        'lax'), see ops/attention.py.

        Returns (out [B,3,H,W] — linear, no tanh; taps {'inner_cos',
        'inner_cos2'} [B,8ngf,H/8,W/8])."""
        return self.model(x, {"ref_feat": ref_feat, "flag": flag,
                              "impl": attention_impl})
