"""DPT-style decoder blocks, the port of
``patchrefinerv2_tpu/models/blocks/dpt.py`` (``upsample_bilinear_ac`` :29,
``GatedConvUnit`` :96, ``GatedFusionBlock`` :196, ``FeatureFusionBlock``
:235, ``C2FModule`` :302), plain layout only (no space-to-depth tail).

Names follow the reference's torch modules
(bi_directional_fusion_model.py: ``GateresConfUnit1/2`` with ``conv`` and
``fusion_conv``; depth_anything blocks: ``resConfUnit1/2``, ``out_conv``).
A block called with one input has no first unit: the reference's unit there
is dead weight, which the JAX converter drops too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.blocks.convs import (
    ChannelLayerNorm, ResidualConvUnit, conv3, interp,
)


def upsample_bilinear_ac(x: torch.Tensor, size=None, scale: int = 2) -> torch.Tensor:
    h, w = x.shape[2:]
    return interp(x, size if size is not None else (h * scale, w * scale))


class GatedConvUnit(nn.Module):
    """out = x + conv(relu x); with fusion: f = 1x1(relu(LN(conv(cat(out, c)))));
    gate => out * sigmoid(f), else f. The LN and the ReLU after it run as one
    K6 launch; the convolutions go to cuDNN."""

    def __init__(self, features: int, coarse_ch: int, gate: bool = True, fusion: bool = True):
        super().__init__()
        self.gate, self.fusion = gate, fusion
        self.conv = conv3(features, features)
        if fusion:
            self.fusion_conv = nn.Sequential(
                conv3(features + coarse_ch, features), ChannelLayerNorm(features), nn.ReLU(),
                nn.Conv2d(features, features, 1, bias=False))

    def forward(self, x, c_feat=None):
        out = self.conv(F.relu(x)) + x
        if not self.fusion:
            return out
        fc = self.fusion_conv
        fused = fc[1](fc[0](torch.cat([out, c_feat], dim=1)), relu=True)
        fused = fc[3](fused)
        return out * torch.sigmoid(fused) if self.gate else fused


class GatedFusionBlock(nn.Module):
    def __init__(self, features: int, coarse_ch: int, skip: bool, gate: bool = True,
                 fusion: bool = True):
        super().__init__()
        if skip:
            self.GateresConfUnit1 = GatedConvUnit(features, coarse_ch, gate, fusion)
        self.GateresConfUnit2 = GatedConvUnit(features, coarse_ch, gate, fusion)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None, coarse_feat=None, upscale: bool = True):
        out = x
        if skip is not None:
            out = out + self.GateresConfUnit1(skip, coarse_feat)
        out = self.GateresConfUnit2(out, coarse_feat)
        if upscale:
            out = upsample_bilinear_ac(out, size=size)
        return self.out_conv(out)


class FeatureFusionBlock(nn.Module):
    """Plain DPT fusion block (depth_anything/blocks.py:99-150)."""

    def __init__(self, features: int, skip: bool):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        return self.out_conv(upsample_bilinear_ac(out, size=size))


class C2FModule(nn.Module):
    """Coarse-to-fine DPT decoder over the refiner's 5 encoder levels (high
    to low resolution) with a coarse level injected at every refinenet.
    ``coarse_chl``: channels of the 6 coarse levels, highest resolution
    first. Returns (feats [l5_rn, p5, p4, p3, p2, last_feat], out)."""

    def __init__(self, fine_chl, coarse_chl, features: int = 256, head2_features: int = 32,
                 gate: bool = True, fusion: bool = True):
        super().__init__()
        s = nn.Module()
        for k in range(1, 6):
            setattr(s, f"layer{k}_rn", nn.Conv2d(fine_chl[k - 1], features, 3, 1, 1, bias=False))
        for k in range(1, 6):
            setattr(s, f"refinenet{k}",
                    GatedFusionBlock(features, coarse_chl[k], skip=(k != 5), gate=gate, fusion=fusion))
        s.output_conv1 = conv3(features, features // 2)
        s.output_conv2 = nn.Sequential(conv3(features // 2, head2_features), nn.ReLU())
        s.output_conv2_fusion = GatedFusionBlock(head2_features, coarse_chl[0], skip=False,
                                                 gate=gate, fusion=fusion)
        s.output_conv3 = nn.Sequential(nn.Conv2d(head2_features, 1, 1))
        self.scratch = s

    def forward(self, fine_features, coarse_features):
        s = self.scratch
        l1, l2, l3, l4, l5 = (getattr(s, f"layer{k + 1}_rn")(f) for k, f in enumerate(fine_features))
        p5 = s.refinenet5(l5, size=l4.shape[2:], coarse_feat=coarse_features[5])
        p4 = s.refinenet4(p5, l4, size=l3.shape[2:], coarse_feat=coarse_features[4])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:], coarse_feat=coarse_features[3])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:], coarse_feat=coarse_features[2])
        p1 = s.refinenet1(p2, l1, coarse_feat=coarse_features[1])
        out = s.output_conv1(p1)
        last_feat = F.relu(s.output_conv2[0](out))
        last_feat = s.output_conv2_fusion(last_feat, coarse_feat=coarse_features[0], upscale=False)
        out = s.output_conv3[0](last_feat)
        return [l5, p5, p4, p3, p2, last_feat], out
