"""BiDirectionalFusion, the port of
``patchrefinerv2_tpu/models/blocks/fusion.py`` (``UpSample`` :35,
``BiDirectionalFusion`` :98) with the coarse-gated (or coarse-fusion) C2F
module and the plain tail layout. The JAX default runs the full-resolution
C=32 tail in space-to-depth form (``ops/s2d.py``), an exact relayout, so the
plain layout agrees with it to within float32 summation order.

Names follow the reference's torch module (``c2f``, ``fusion_layers_1/2``,
``f2r_agg``, ``final_conv``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.blocks.convs import DoubleConv, SingleConvCNNLN, interp
from patchrefinerv2_torch.models.blocks.dpt import C2FModule


class UpSample(nn.Module):
    """Upscale-concat-DoubleConv decoder stage (fusion_model.py:7-35)."""

    def __init__(self, out_ch: int, mid_ch: int):
        super().__init__()
        self.conv = DoubleConv(mid_ch, out_ch, mid_ch)

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
        self.fusion_layers_1 = nn.ModuleList(
            SingleConvCNNLN(coarse_chl[i] + f_after[i], temp_chl[i]) for i in range(n))
        self.fusion_layers_2 = nn.ModuleList(
            SingleConvCNNLN(temp_chl[i] + 2, temp_chl[i]) for i in range(n))
        mids = list(temp_chl)[::-1]
        in_mid, aggs = mids[0], []
        for idx, dec_c in enumerate(dec_chl):
            aggs.append(UpSample(dec_c, mids[idx + 1] + in_mid + 2))
            in_mid = dec_c
        self.f2r_agg = nn.ModuleList(aggs)
        self.final_conv = nn.Conv2d(dec_chl[-1], 1, 3, 1, 1, bias=False)

    def forward(self, c_feat, f_feat, pred1, pred2, update_base=None):
        c_feat = [interp(c, f.shape[2:]) for c, f in zip(c_feat, f_feat)]
        c2f_feats, pred2 = self.c2f(list(f_feat)[1:], c_feat)
        f_feat = c2f_feats[::-1]
        temp = []
        for idx, (c, f) in enumerate(zip(c_feat, f_feat)):
            h = self.fusion_layers_1[idx](torch.cat([c, f], dim=1))
            size = h.shape[2:]
            h = self.fusion_layers_2[idx](torch.cat([h, interp(pred1, size), interp(pred2, size)], dim=1))
            temp.append(h)
        rev = temp[::-1]
        cur = rev[0]
        for idx, agg in enumerate(self.f2r_agg):
            cur = agg(cur, rev[1 + idx], pred1, pred2)
        offset = self.final_conv(cur)
        if update_base is None:
            return offset
        return torch.clamp(update_base + offset, min=0.0)
