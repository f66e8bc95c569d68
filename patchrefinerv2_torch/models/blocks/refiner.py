"""LightWeightRefiner, the port of
``patchrefinerv2_tpu/models/blocks/refiner.py:31``: the patch crop
normalised with the encoder's statistics, the roi-aligned coarse depth as a
4th channel (``coarse_condition``), the encoder (EfficientNet-B5 or
MobileNetV4, :data:`ENCODER_SPECS`), and then either a 2x bilinear
(align_corners) copy of the /2 level on top (``with_decoder=False``: 6
levels and a zeros depth) or the ``SimpleDPTHead`` decoder (its 6 levels
and its depth). Levels are returned low -> high resolution; ``channels``
are the widths of the five levels the fusion head's C2F module reads (the
encoder's, or the decoder's 256), ``top_channels`` the width of the
full-resolution level.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.backbones.encoders import (
    EFFB5_CHANNELS, EFFB5_MEAN, EFFB5_STD, EfficientNetB5Features,
)
from patchrefinerv2_torch.models.backbones.mobilenetv4 import MobileNetV4Features
from patchrefinerv2_torch.models.blocks.convs import interp
from patchrefinerv2_torch.models.blocks.dpt import SimpleDPTHead

_HALF = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))

# the port's copy of the JAX package's ``ENCODER_SPECS``
# (backbones/encoders.py:257-328): each encoder's class, the widths of its
# five levels and its pretraining mean/std
ENCODER_SPECS = {
    "tf_efficientnet_b5_ap": dict(cls=EfficientNetB5Features, channels=list(EFFB5_CHANNELS),
                                  mean=EFFB5_MEAN, std=EFFB5_STD),
    "mobilenetv4_conv_small.e2400_r224_in1k": dict(
        cls=functools.partial(MobileNetV4Features, variant="small"),
        channels=[32, 32, 64, 96, 960], **_HALF),
    "mobilenetv4_conv_medium.e500_r256_in1k": dict(
        cls=functools.partial(MobileNetV4Features, variant="medium"),
        channels=[32, 48, 80, 160, 960], **_HALF),
    "mobilenetv4_conv_large.e600_r384_in1k": dict(
        cls=functools.partial(MobileNetV4Features, variant="large"),
        channels=[24, 48, 96, 192, 960], **_HALF),
}

_CONVNEXT = ("ConvNeXt refiners are not ported: the JAX package cannot build them either "
             "(ConvNeXtFeatures returns 4 levels, and BiDirectionalFusion's C2F unpacks 5)")
_UNPORTED = {
    "convnext_large": _CONVNEXT,
    "convnextv2_large": _CONVNEXT,
    "convnextv2_large.fcmae_ft_in22k_in1k_384": _CONVNEXT,
    "mobilenetv3_large_100": "the MobileNetV3 refiner is not ported (no config uses it)",
}


def encoder_entry(name: str) -> dict:
    """The :data:`ENCODER_SPECS` entry of ``name``; NotImplementedError for
    an encoder the port does not have."""
    if name in ENCODER_SPECS:
        return ENCODER_SPECS[name]
    raise NotImplementedError(_UNPORTED.get(name, f"encoder {name!r} is not implemented; "
                                                  f"the port has {sorted(ENCODER_SPECS)}"))


class LightWeightRefiner(nn.Module):
    def __init__(self, encoder_name: str = "tf_efficientnet_b5_ap", coarse_condition: bool = True,
                 with_decoder: bool = False, encoder_spec: dict | None = None):
        super().__init__()
        spec = encoder_entry(encoder_name)
        self.coarse_condition = coarse_condition
        kw = {} if encoder_spec is None else {"spec": encoder_spec}
        self.refiner_encoder = spec["cls"](in_ch=4 if coarse_condition else 3, **kw)
        enc_chl = spec["channels"] if encoder_spec is None else self.refiner_encoder.channels
        self.decoder = SimpleDPTHead(enc_chl) if with_decoder else None
        self.channels = self.decoder.channels if with_decoder else list(enc_chl)
        # the decoder's last_feat (output_conv2: 32 wide), else the 2x copy of the /2 level
        self.top_channels = 32 if with_decoder else enc_chl[0]
        self.register_buffer("mean", torch.tensor(spec["mean"]).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(spec["std"]).view(1, 3, 1, 1), persistent=False)

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
