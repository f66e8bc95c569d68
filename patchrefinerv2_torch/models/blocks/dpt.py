"""DPT-style decoder blocks, the port of
``patchrefinerv2_tpu/models/blocks/dpt.py`` (``upsample_bilinear_ac`` :29,
``GatedConvUnit`` :96, ``GatedFusionBlock`` :196, ``FeatureFusionBlock``
:235, ``SimpleDPTHead`` :266, ``C2FModule`` :302). ``tail=True`` marks the full-resolution head
instance, which the JAX package runs in space-to-depth form
(``s2d``/``s2d_tail``): there every convolution is a K9 launch
(``ops/tail_conv.py``) with its epilogue fused and its concatenated inputs
read in place.

Names follow the reference's torch modules
(bi_directional_fusion_model.py: ``GateresConfUnit1/2`` with ``conv`` and
``fusion_conv``; depth_anything blocks: ``resConfUnit1/2``, ``out_conv``).
A block called with one input has no first unit: the reference's unit there
is dead weight, which the JAX converter drops too.

The convolutions that the reference routes through its int8 dispatcher are
int8 sites (``models/int8.py``): a GatedConvUnit's ``conv`` and
``fusion_conv[0]`` (its 1x1 inside K5 raises if selected), the C2F
``output_conv1``, and in the head, which the reference runs in
space-to-depth form, ``output_conv2`` (``qsd_0``) and the head unit's
``conv`` and ``fusion_conv[0]`` with that layout. Where the int8 mode serves
a head site, K10 takes it from K9.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.blocks.convs import (
    ChannelLayerNorm, ResidualConvUnit, conv3, interp, to_nchw, to_nhwc,
)
from patchrefinerv2_torch.models.int8 import int8_conv, mark_site
from patchrefinerv2_torch.ops.gated import gate_tail
from patchrefinerv2_torch.ops.tail_conv import tail_conv


def upsample_bilinear_ac(x: torch.Tensor, size=None, scale: int = 2) -> torch.Tensor:
    h, w = x.shape[2:]
    return interp(x, size if size is not None else (h * scale, w * scale))


class GatedConvUnit(nn.Module):
    """out = x + conv(relu x); with fusion: f = 1x1(relu(LN(conv(cat(out, c)))));
    gate => out * sigmoid(f), else f. The 3x3 convolutions go to K10 where
    the int8 mode serves them, else to cuDNN, or with ``tail`` each to one K9
    launch (``conv(relu x) + x``, and the fusion conv reading ``out`` and
    ``c`` in place); the rest after the fusion conv (LN, ReLU, the 1x1, the
    gate) is one K5 launch."""

    def __init__(self, features: int, coarse_ch: int, gate: bool = True, fusion: bool = True,
                 tail: bool = False):
        super().__init__()
        self.gate, self.fusion, self.tail = gate, fusion, tail
        self.conv = conv3(features, features)
        # the reference's dispatcher sites: in space-to-depth form with
        # ``tail`` (there a unit without fusion has one too, dpt.py:136-143)
        layout = "s2d" if tail else "plain"
        if fusion or tail:
            mark_site(self.conv, "qamax_0", layout=layout)
        if fusion:
            self.fusion_conv = nn.Sequential(
                conv3(features + coarse_ch, features), ChannelLayerNorm(features), nn.ReLU(),
                nn.Conv2d(features, features, 1, bias=False))
            mark_site(self.fusion_conv[0], "qamax_1", layout=layout)
            mark_site(self.fusion_conv[3], "qamax_2", unported=True, layout=layout)

    def forward(self, x, c_feat=None):
        out = int8_conv(self.conv, [x], relu_in=True, residual=x)
        if out is None and self.tail:
            xh = to_nhwc(x)
            out = to_nchw(tail_conv([xh], self.conv.weight, self.conv.bias, residual=xh, relu_in=True))
        elif out is None:
            out = self.conv(F.relu(x)) + x
        if not self.fusion:
            return out
        fc = self.fusion_conv
        f = int8_conv(fc[0], [out, c_feat])
        if f is None and self.tail:
            f = to_nchw(tail_conv([to_nhwc(out), to_nhwc(c_feat)], fc[0].weight, fc[0].bias))
        elif f is None:
            f = fc[0](torch.cat([out, c_feat], dim=1))
        int8_conv(fc[3], [f])  # K5's 1x1: raises where the gate would select it
        y = gate_tail(to_nhwc(f), to_nhwc(out) if self.gate else None, fc[3].weight, fc[1].weight,
                      fc[1].bias, fc[1].eps)
        return to_nchw(y)


class GatedFusionBlock(nn.Module):
    """Gated units, then an optional x2 upsample and the 1x1 ``out_conv``
    (K9 with ``tail``)."""

    def __init__(self, features: int, coarse_ch: int, skip: bool, gate: bool = True,
                 fusion: bool = True, tail: bool = False):
        super().__init__()
        self.tail = tail
        if skip:
            self.GateresConfUnit1 = GatedConvUnit(features, coarse_ch, gate, fusion, tail)
        self.GateresConfUnit2 = GatedConvUnit(features, coarse_ch, gate, fusion, tail)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None, coarse_feat=None, upscale: bool = True):
        out = x
        if skip is not None:
            out = out + self.GateresConfUnit1(skip, coarse_feat)
        out = self.GateresConfUnit2(out, coarse_feat)
        if upscale:
            out = upsample_bilinear_ac(out, size=size)
        if self.tail:
            return to_nchw(tail_conv([to_nhwc(out)], self.out_conv.weight, self.out_conv.bias))
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


class SimpleDPTHead(nn.Module):
    """The refiner's 5-level DPT decoder (``with_decoder``, reference
    lightweight_refiner.py:61-137): 3x3 no-bias projections of the five
    encoder levels to ``features`` (``Scratch``), FeatureFusionBlocks from
    the lowest resolution up (each upsample K2), then ``output_conv1``
    (3x3, features / 2), ``output_conv2`` (3x3 to 32, ReLU) and the 1x1
    ``output_conv3``, all at the patch resolution. Returns (feats [l5_rn,
    p5, p4, p3, p2, last_feat], low to high resolution; out (B, 1, h, w)).
    ``output_conv3``'s weight is drawn normal with mean 1.0
    (:func:`init_output_conv3_`), as the reference initialises it."""

    def __init__(self, in_chl, features: int = 256):
        super().__init__()
        s = nn.Module()
        for k in range(1, 6):
            setattr(s, f"layer{k}_rn", nn.Conv2d(in_chl[k - 1], features, 3, 1, 1, bias=False))
        for k in range(1, 6):
            setattr(s, f"refinenet{k}", FeatureFusionBlock(features, skip=(k != 5)))
        s.output_conv1 = conv3(features, features // 2)
        s.output_conv2 = nn.Sequential(conv3(features // 2, 32), nn.ReLU())
        s.output_conv3 = nn.Sequential(nn.Conv2d(32, 1, 1))
        self.scratch = s
        self.channels = [features] * 5

    def init_output_conv3_(self, generator: torch.Generator) -> None:
        w = self.scratch.output_conv3[0].weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=generator) + 1.0)

    def forward(self, feats):
        s = self.scratch
        l1, l2, l3, l4, l5 = (getattr(s, f"layer{k + 1}_rn")(f) for k, f in enumerate(feats))
        p5 = s.refinenet5(l5, size=l4.shape[2:])
        p4 = s.refinenet4(p5, l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        last_feat = s.output_conv2(s.output_conv1(p1))
        return [l5, p5, p4, p3, p2, last_feat], s.output_conv3(last_feat)


class C2FModule(nn.Module):
    """Coarse-to-fine DPT decoder over the refiner's 5 encoder levels (high
    to low resolution) with a coarse level injected at every refinenet.
    ``coarse_chl``: channels of the 6 coarse levels, highest resolution
    first. The full-resolution head (``output_conv2``, its gated block and
    ``output_conv3``) runs on K9, where the JAX module's ``s2d_tail`` runs
    it in space-to-depth form, or on K10 where the int8 mode serves its
    sites. Returns (feats [l5_rn, p5, p4, p3, p2, last_feat], out)."""

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
        mark_site(s.output_conv1, "qamax_0")
        s.output_conv2 = nn.Sequential(conv3(features // 2, head2_features), nn.ReLU())
        mark_site(s.output_conv2[0], "qsd_0", layout="s2d_down")
        s.output_conv2_fusion = GatedFusionBlock(head2_features, coarse_chl[0], skip=False,
                                                 gate=gate, fusion=fusion, tail=True)
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
        out = int8_conv(s.output_conv1, [p1])
        if out is None:
            out = s.output_conv1(p1)
        oc2, oc3 = s.output_conv2[0], s.output_conv3[0]
        last_feat = int8_conv(oc2, [out], relu_out=True)
        if last_feat is None:
            last_feat = to_nchw(tail_conv([to_nhwc(out)], oc2.weight, oc2.bias, act="relu"))
        last_feat = s.output_conv2_fusion(last_feat, coarse_feat=coarse_features[0], upscale=False)
        out = to_nchw(tail_conv([to_nhwc(last_feat)], oc3.weight, oc3.bias))
        return [l5, p5, p4, p3, p2, last_feat], out
