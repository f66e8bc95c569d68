"""BiDirectionalFusion, the port of
``patchrefinerv2_tpu/models/blocks/fusion.py`` (``UpSample`` :35,
``BiDirectionalFusion`` :98) with the coarse-gated (or coarse-fusion) C2F
module. The JAX default runs the full-resolution low-channel tail in
space-to-depth form (``ops/s2d.py``), an exact re-layout; the port runs the
same sites (the C2F head, ``fusion_layers_1/2[0]``, the last ``f2r_agg``
stage's second conv and ``final_conv``) on K9 (``ops/tail_conv.py``) in the
plain layout, which agrees with it to within float32 summation order.

Names follow the reference's torch module (``c2f``, ``fusion_layers_1/2``,
``f2r_agg``, ``final_conv``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.blocks.convs import (
    DoubleConv, SingleConvCNNLN, interp, to_nchw, to_nhwc,
)
from patchrefinerv2_torch.models.blocks.dpt import C2FModule
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


class BiDirectionalFusion(nn.Module):
    """V2 fusion head. ``coarse_chl``: channels of the 6 coarse levels and
    ``fine_chl``: channels of the 5 encoder levels, both highest resolution
    first; ``head2_features`` is the config's ``coarse_chl[0]``."""

    def __init__(self, coarse_chl, fine_chl, temp_chl=(32, 64, 64, 128, 256, 512),
                 dec_chl=(512, 256, 128, 64, 32), coarse2fine: bool = True,
                 coarse2fine_type: str = "coarse-gated", glb_att: bool = False,
                 c2f_features: int = 256, head2_features: int = 32):
        super().__init__()
        if not coarse2fine or coarse2fine_type not in ("coarse-gated", "coarse-fusion") or glb_att:
            raise NotImplementedError(
                "the port covers BiDirectionalFusion with a coarse-gated or coarse-fusion C2F "
                "module and no global attention")
        self.c2f = C2FModule(fine_chl, coarse_chl, c2f_features, head2_features,
                             gate=coarse2fine_type == "coarse-gated", fusion=True)
        f_after = [head2_features] + [c2f_features] * 5
        n = len(temp_chl)
        # level 0 is the full-resolution one: its two fusion layers run on K9
        self.fusion_layers_1 = nn.ModuleList(
            SingleConvCNNLN(coarse_chl[i] + f_after[i], temp_chl[i], tail=i == 0) for i in range(n))
        self.fusion_layers_2 = nn.ModuleList(
            SingleConvCNNLN(temp_chl[i] + 2, temp_chl[i], tail=i == 0) for i in range(n))
        mids = list(temp_chl)[::-1]
        in_mid, aggs = mids[0], []
        for idx, dec_c in enumerate(dec_chl):
            aggs.append(UpSample(dec_c, mids[idx + 1] + in_mid + 2, tail=idx == len(dec_chl) - 1))
            in_mid = dec_c
        self.f2r_agg = nn.ModuleList(aggs)
        self.final_conv = nn.Conv2d(dec_chl[-1], 1, 3, 1, 1, bias=False)

    def forward(self, c_feat, f_feat, pred1, pred2, update_base=None):
        c_feat = [interp(c, f.shape[2:]) for c, f in zip(c_feat, f_feat)]
        c2f_feats, pred2 = self.c2f(list(f_feat)[1:], c_feat)
        f_feat = c2f_feats[::-1]
        temp = []
        for idx, (c, f) in enumerate(zip(c_feat, f_feat)):
            h = self.fusion_layers_1[idx](c, f)
            size = h.shape[2:]
            h = self.fusion_layers_2[idx](h, interp(pred1, size), interp(pred2, size))
            temp.append(h)
        rev = temp[::-1]
        cur = rev[0]
        for idx, agg in enumerate(self.f2r_agg):
            cur = agg(cur, rev[1 + idx], pred1, pred2)
        # K9: offset = final_conv(cur), or clamp(update_base + offset, 0)
        res = None if update_base is None else to_nhwc(update_base)
        return to_nchw(tail_conv([to_nhwc(cur)], self.final_conv.weight, residual=res,
                                 act="none" if res is None else "relu"))
