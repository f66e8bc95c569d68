"""DPT head over DINOv2 tokens and the Depth-Anything-V2 metric model, the
port of ``patchrefinerv2_tpu/models/backbones/dpt.py`` (``DA2_OUT_CHANNELS``
:27, ``DPTHead`` :36, ``DepthAnythingV2`` :90).

Key names follow the DA2 torch state dict (depth_anything_v2/dpt.py):
``pretrained`` (the DINOv2 trunk) and ``depth_head.{projects.{i},
resize_layers.{0, 1, 3}, scratch.{layer{k}_rn, refinenet{k},
output_conv1, output_conv2.{0, 2}}}``. ``refinenet4`` is called with one
input, so it has no first unit, as the JAX converter drops it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.backbones.vit import DinoViT
from patchrefinerv2_torch.models.blocks.convs import interp, to_nchw
from patchrefinerv2_torch.models.blocks.dpt import FeatureFusionBlock

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

DA2_OUT_CHANNELS = {
    "vits": [48, 96, 192, 384],
    "vitb": [96, 192, 384, 768],
    "vitl": [256, 512, 1024, 1024],
    "vitg": [1536, 1536, 1536, 1536],
    "vitt": [24, 48, 96, 96],  # debug-tiny
}


class DPTHead(nn.Module):
    """4-level DPT head (depth_anything_v2/dpt.py:38-150) over the tap
    tokens of a (ph, pw) patch grid. Returns (depth in [0, 1] (B, 1, 14 ph,
    14 pw), [l4_rn, p4, p3, p2, p1, out_feat])."""

    def __init__(self, in_channels: int, features: int = 256, out_channels=(48, 96, 192, 384)):
        super().__init__()
        oc = list(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, 4), nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(), nn.Conv2d(oc[3], oc[3], 3, 2, 1)])
        s = nn.Module()
        for i, c in enumerate(oc):
            setattr(s, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, 1, 1, bias=False))
        for k in range(1, 5):
            setattr(s, f"refinenet{k}", FeatureFusionBlock(features, skip=(k != 4)))
        s.output_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        s.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.Sigmoid())
        self.scratch = s

    def forward(self, tap_tokens, grid):
        ph, pw = grid
        levels = []
        for i, (tokens, _cls) in enumerate(tap_tokens):
            x = to_nchw(tokens.reshape(tokens.shape[0], ph, pw, -1))
            levels.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(lv) for i, lv in enumerate(levels))
        p4 = s.refinenet4(l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        out_feat = interp(s.output_conv1(p1), (ph * 14, pw * 14))
        head = s.output_conv2
        depth = torch.sigmoid(head[2](F.relu(head[0](out_feat))))
        return depth, [l4, p4, p3, p2, p1, out_feat]


class DepthAnythingV2(nn.Module):
    """DA2 metric model (depth_anything_v2/dpt.py:153-203): input NCHW in
    [0, 1]; returns dict(metric_depth (B, 1, H, W) = sigmoid * max_depth,
    coarse_features = the head's 6-level pyramid)."""

    def __init__(self, encoder: str = "vitl", features: int = 256, max_depth: float = 20.0):
        super().__init__()
        self.max_depth = max_depth
        self.pretrained = DinoViT(variant=encoder)
        out_channels = DA2_OUT_CHANNELS[encoder]
        self.depth_head = DPTHead(self.pretrained.cls_token.shape[-1], features, out_channels)
        # channels of the 6 coarse levels, highest resolution first
        self.coarse_chl = [features // 2] + [features] * 5

    def forward(self, x):
        if x.shape[2] % 14 or x.shape[3] % 14:
            raise NotImplementedError(
                "the Depth-Anything resizer (sides rounded to multiples of 14, "
                f"patchrefinerplus.py:59) is not ported: got sides {tuple(x.shape[2:])}")
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        x = (x - mean) / std
        grid = (x.shape[2] // 14, x.shape[3] // 14)
        depth01, feats = self.depth_head(self.pretrained(x), grid)
        return {"metric_depth": depth01 * self.max_depth, "coarse_features": feats}
