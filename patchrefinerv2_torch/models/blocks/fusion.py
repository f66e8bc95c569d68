"""The fusion heads, the port of ``patchrefinerv2_tpu/models/blocks/fusion.py``
(``UpSample`` :35, ``FusionUnet`` :57, ``BiDirectionalFusion`` :98).

BiDirectionalFusion (V2) comes with the coarse-gated, coarse-fusion or
self-agg C2F module, or none (``coarse2fine=False``: the fusion layers read
the refiner's own 6 levels and depth). The JAX default runs the
full-resolution low-channel tail in
space-to-depth form (``ops/s2d.py``), an exact re-layout; the port runs the
same sites (the C2F head, ``fusion_layers_1/2[0]``, the last ``f2r_agg``
stage's second conv and ``final_conv``) on K9 (``ops/tail_conv.py``) in the
plain layout, which agrees with it to within float32 summation order.

FusionUnet (PatchRefiner V1) is the same encoder-decoder without C2F over
the coarse and fine depth networks' pyramids. The JAX package runs it in
plain convolutions; the port runs its full-resolution sites
(``encoder_layers_1/2[0]``, the last decoder stage's second conv and
``final_conv``) on K9, as BiDirectionalFusion's.

Names follow the reference's torch modules (``c2f``, ``fusion_layers_1/2``,
``f2r_agg``, ``final_conv``; ``encoder_layers_1/2``, ``decoder_layers``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.blocks.convs import (
    DoubleConv, SingleConvCNNLN, interp, to_nchw, to_nhwc,
)
from patchrefinerv2_torch.models.blocks.dpt import C2FModule, GatedConvUnit, GatedFusionBlock
from patchrefinerv2_torch.ops.tail_conv import tail_conv


class UpSample(nn.Module):
    """Upscale-concat-DoubleConv decoder stage (fusion_model.py:7-35);
    ``tail``: the DoubleConv's second conv on K9."""

    def __init__(self, out_ch: int, mid_ch: int, tail: bool = False):
        super().__init__()
        self.conv = DoubleConv(mid_ch, out_ch, mid_ch, tail=tail)

    def forward(self, x1, x2, pred1, pred2):
        size = x2.shape[2:]
        x = torch.cat([interp(x1, size), x2, interp(pred1, size), interp(pred2, size)], dim=1)
        return self.conv(x)


def _unet(in_chl, temp_chl, dec_chl):
    """The encoder-decoder both heads share (fusion_model.py:52-123): per
    level a SingleConvCNNLN on cat(coarse, fine) and one on cat(h, pred1,
    pred2), the UpSample stages and the bias-free 3x3 offset conv. Level 0
    is the full-resolution one: its two layers, the last stage's second conv
    and the offset conv run on K9."""
    n = len(temp_chl)
    layers_1 = nn.ModuleList(SingleConvCNNLN(in_chl[i], temp_chl[i], tail=i == 0) for i in range(n))
    layers_2 = nn.ModuleList(SingleConvCNNLN(temp_chl[i] + 2, temp_chl[i], tail=i == 0) for i in range(n))
    mids = list(temp_chl)[::-1]
    in_mid, stages = mids[0], []
    for idx, dec_c in enumerate(dec_chl):
        stages.append(UpSample(dec_c, mids[idx + 1] + in_mid + 2, tail=idx == len(dec_chl) - 1))
        in_mid = dec_c
    return layers_1, layers_2, nn.ModuleList(stages), nn.Conv2d(dec_chl[-1], 1, 3, 1, 1, bias=False)


def _unet_forward(layers_1, layers_2, stages, final_conv, c_feat, f_feat, pred1, pred2, update_base):
    temp = []
    for l1, l2, c, f in zip(layers_1, layers_2, c_feat, f_feat):
        h = l1(c, f)
        size = h.shape[2:]
        temp.append(l2(h, interp(pred1, size), interp(pred2, size)))
    rev = temp[::-1]
    cur = rev[0]
    for stage, feat in zip(stages, rev[1:]):
        cur = stage(cur, feat, pred1, pred2)
    # K9: offset = final_conv(cur), or clamp(update_base + offset, 0)
    res = None if update_base is None else to_nhwc(update_base)
    return to_nchw(tail_conv([to_nhwc(cur)], final_conv.weight, residual=res,
                             act="none" if res is None else "relu"))


def _tail_calls(head) -> int:
    """K9's launches in one call of ``head`` at its tail SingleConvCNNLNs,
    DoubleConvs and GatedFusionBlocks (their ``out_conv``) and its
    ``final_conv``."""
    return sum(1 for m in head.modules()
               if isinstance(m, (SingleConvCNNLN, DoubleConv, GatedFusionBlock)) and m.tail) + 1


class BiDirectionalFusion(nn.Module):
    """V2 fusion head. ``coarse_chl``: channels of the 6 coarse levels and
    ``fine_chl``: channels of the refiner's 5 levels that C2F reads, both
    highest resolution first; ``fine_top_chl``: the refiner's
    full-resolution level (default ``fine_chl[0]``, the 2x copy of its /2
    level), which only ``coarse2fine=False`` reads; ``head2_features`` is
    the config's ``coarse_chl[0]``. The C2F forms (JAX fusion.py:170-200):
    ``coarse-gated`` (gate and fusion), ``coarse-fusion`` (fusion) and
    ``self-agg`` (neither: its GatedConvUnits have no fusion conv and
    launch no K5)."""

    def __init__(self, coarse_chl, fine_chl, temp_chl=(32, 64, 64, 128, 256, 512),
                 dec_chl=(512, 256, 128, 64, 32), coarse2fine: bool = True,
                 coarse2fine_type: str = "coarse-gated", glb_att: bool = False,
                 c2f_features: int = 256, head2_features: int = 32, fine_top_chl: int | None = None):
        super().__init__()
        if coarse2fine and coarse2fine_type not in ("coarse-gated", "coarse-fusion", "self-agg"):
            raise NotImplementedError(
                f"the C2F form {coarse2fine_type!r} is not ported (coarse-gated, coarse-fusion, "
                "self-agg are)")
        if glb_att:
            raise NotImplementedError("BiDirectionalFusion with global attention is not ported")
        if coarse2fine:
            self.c2f = C2FModule(fine_chl, coarse_chl, c2f_features, head2_features,
                                 gate=coarse2fine_type == "coarse-gated",
                                 fusion=coarse2fine_type != "self-agg")
            f_after = [head2_features] + [c2f_features] * 5
        else:
            self.c2f = None
            f_after = [fine_chl[0] if fine_top_chl is None else fine_top_chl] + list(fine_chl)
        (self.fusion_layers_1, self.fusion_layers_2, self.f2r_agg,
         self.final_conv) = _unet([c + f for c, f in zip(coarse_chl, f_after)], temp_chl, dec_chl)

    def forward(self, c_feat, f_feat, pred1, pred2, update_base=None):
        c_feat = [interp(c, f.shape[2:]) for c, f in zip(c_feat, f_feat)]
        if self.c2f is not None:
            c2f_feats, pred2 = self.c2f(list(f_feat)[1:], c_feat)
            f_feat = c2f_feats[::-1]
        return _unet_forward(self.fusion_layers_1, self.fusion_layers_2, self.f2r_agg,
                             self.final_conv, c_feat, f_feat, pred1, pred2, update_base)

    def kernel_calls(self) -> dict:
        """The K5 and K9 launches of one call, counted from the modules: K5
        once at each GatedConvUnit with a fusion conv; K9 at each tail
        site: a tail SingleConvCNNLN, DoubleConv or GatedFusionBlock
        (its ``out_conv``) once, a tail GatedConvUnit once and once more
        with a fusion conv, C2F's ``output_conv2`` and ``output_conv3``, and
        ``final_conv``. In the int8 mode K10 takes the head sites it serves
        from K9."""
        units = [m for m in self.modules() if isinstance(m, GatedConvUnit)]
        k9 = _tail_calls(self) + sum(1 + u.fusion for u in units if u.tail)
        return {"gate_tail": sum(u.fusion for u in units),
                "tail_conv": k9 + (2 if self.c2f is not None else 0)}


class FusionUnet(nn.Module):
    """V1 offset head (JAX fusion.py:57-94) over the coarse and the fine
    depth networks' 6 levels, highest resolution first: ``in_chl`` the
    channels of each level's cat(coarse, fine) (the config's
    ``input_chl``), ``temp_chl`` and ``dec_chl`` the encoder's and the
    decoder's widths."""

    def __init__(self, in_chl, temp_chl=(32, 256, 256), dec_chl=(256, 32)):
        super().__init__()
        (self.encoder_layers_1, self.encoder_layers_2, self.decoder_layers,
         self.final_conv) = _unet(in_chl, temp_chl, dec_chl)

    def forward(self, c_feat, f_feat, pred1, pred2, update_base=None):
        return _unet_forward(self.encoder_layers_1, self.encoder_layers_2, self.decoder_layers,
                             self.final_conv, c_feat, f_feat, pred1, pred2, update_base)

    def kernel_calls(self) -> dict:
        """The K5, K9 and K6 launches of one call, counted from the modules:
        no K5; K9 at the tail SingleConvCNNLNs, the tail DoubleConv and
        ``final_conv``; K6 at every other SingleConvCNNLN's LayerNorm."""
        layers = [m for m in self.modules() if isinstance(m, SingleConvCNNLN)]
        return {"gate_tail": 0, "tail_conv": _tail_calls(self),
                "layer_norm": sum(not m.tail for m in layers)}
