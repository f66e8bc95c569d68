"""LightWeightRefiner, the port of
``patchrefinerv2_tpu/models/blocks/refiner.py:31`` (encoder-only form,
``with_decoder=False``): the patch crop normalised with the encoder's
statistics, the roi-aligned coarse depth as a 4th channel, the
EfficientNet-B5 encoder, and a 2x bilinear (align_corners) copy of the /2
level on top. Returns (6 levels low -> high resolution, zeros depth).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.backbones.encoders import (
    EFFB5_CHANNELS, EFFB5_MEAN, EFFB5_STD, EfficientNetB5Features,
)
from patchrefinerv2_torch.models.blocks.convs import interp


class LightWeightRefiner(nn.Module):
    def __init__(self, encoder_name: str = "tf_efficientnet_b5_ap", coarse_condition: bool = True,
                 with_decoder: bool = False):
        super().__init__()
        if encoder_name != "tf_efficientnet_b5_ap" or with_decoder:
            raise NotImplementedError(
                "the port covers LightWeightRefiner with tf_efficientnet_b5_ap and no decoder")
        self.coarse_condition = coarse_condition
        self.channels = list(EFFB5_CHANNELS)
        self.refiner_encoder = EfficientNetB5Features(in_ch=4 if coarse_condition else 3)
        self.register_buffer("mean", torch.tensor(EFFB5_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(EFFB5_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, crop_image, coarse_depth=None):
        """NCHW inputs (channels_last): crop (B, 3, h, w), coarse depth (B, 1, h, w)."""
        x = (crop_image - self.mean.to(crop_image.dtype)) / self.std.to(crop_image.dtype)
        if self.coarse_condition:
            x = torch.cat([x, coarse_depth], dim=1)
        feats = self.refiner_encoder(x)
        top = feats[0]
        feats = [interp(top, (top.shape[2] * 2, top.shape[3] * 2))] + list(feats)
        return feats[::-1], torch.zeros_like(crop_image[:, :1])
