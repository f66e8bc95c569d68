"""LightWeightRefiner, the port of
``patchrefinerv2_tpu/models/blocks/refiner.py:31``: the patch crop
normalised with the encoder's statistics, the roi-aligned coarse depth as a
4th channel (``coarse_condition``), the EfficientNet-B5 encoder, and then
either a 2x bilinear (align_corners) copy of the /2 level on top
(``with_decoder=False``: 6 levels and a zeros depth) or the
``SimpleDPTHead`` decoder (its 6 levels and its depth). Levels are returned
low -> high resolution; ``channels`` are the widths of the five levels the
fusion head's C2F module reads (the encoder's, or the decoder's 256).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.backbones.encoders import (
    EFFB5_CHANNELS, EFFB5_MEAN, EFFB5_STD, EfficientNetB5Features,
)
from patchrefinerv2_torch.models.blocks.convs import interp
from patchrefinerv2_torch.models.blocks.dpt import SimpleDPTHead


class LightWeightRefiner(nn.Module):
    def __init__(self, encoder_name: str = "tf_efficientnet_b5_ap", coarse_condition: bool = True,
                 with_decoder: bool = False):
        super().__init__()
        if encoder_name != "tf_efficientnet_b5_ap":
            raise NotImplementedError("the port covers LightWeightRefiner with tf_efficientnet_b5_ap")
        self.coarse_condition = coarse_condition
        self.refiner_encoder = EfficientNetB5Features(in_ch=4 if coarse_condition else 3)
        self.decoder = SimpleDPTHead(EFFB5_CHANNELS) if with_decoder else None
        self.channels = self.decoder.channels if with_decoder else list(EFFB5_CHANNELS)
        self.register_buffer("mean", torch.tensor(EFFB5_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(EFFB5_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, crop_image, coarse_depth=None):
        """NCHW inputs (channels_last): crop (B, 3, h, w), coarse depth (B, 1, h, w)."""
        x = (crop_image - self.mean.to(crop_image.dtype)) / self.std.to(crop_image.dtype)
        if self.coarse_condition:
            x = torch.cat([x, coarse_depth], dim=1)
        feats = self.refiner_encoder(x)
        if self.decoder is not None:
            return self.decoder(feats)
        top = feats[0]
        feats = [interp(top, (top.shape[2] * 2, top.shape[3] * 2))] + list(feats)
        return feats[::-1], torch.zeros_like(crop_image[:, :1])
