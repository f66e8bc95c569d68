"""MobileNetV4-Conv (``mobilenetv4_conv_small/medium/large``, features_only)
for the lightweight refiner, the port of
``patchrefinerv2_tpu/models/backbones/mobilenetv4.py`` (``ConvBN`` :43,
``EdgeResidual`` :62, ``UIB`` :87, ``_MNV4_SPECS`` :131, ``unroll_spec``
:208, ``MobileNetV4Features`` :224).

timm's module layout and key names, as ``convert_timm_mnv4`` of the JAX
package reads them: ``conv_stem``/``bn1``, then ``blocks.{stage}.{block}``
holding a ConvBnAct (``conv``, ``bn1``), an EdgeResidual (``conv_exp``,
``bn1``, ``conv_pwl``, ``bn2``) or a UniversalInvertedResidual (the
children ``dw_start``, ``pw_exp``, ``dw_mid`` and ``pw_proj``, each with
``conv`` and ``bn``); the 960-wide 1x1 head is the last stage's only block.
Symmetric ``k // 2`` padding (not TF-SAME), ReLU, BatchNorm with eps 1e-5
(:class:`BatchNorm`: flax's train mode). A UIB strides on ``dw_mid`` when it
has one, else on ``dw_start``; a row's stride applies to its first repeat
only. The reference calls these convolutions directly, not through its int8
dispatcher, so none of them is an int8 site.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.backbones.encoders import BatchNorm

# stage rows: (kind, out_ch, stride, kernel, expand, dw_start, dw_mid, repeats);
# kind "cn" ConvBnAct | "er" EdgeResidual | "uib" UniversalInvertedResidual
# (kernel read for cn/er only, dw_start/dw_mid for uib only)
MNV4_SPECS = {
    "small": dict(
        stem=32,
        stages=[
            [("cn", 32, 2, 3, 0, 0, 0, 1), ("cn", 32, 1, 1, 0, 0, 0, 1)],
            [("cn", 96, 2, 3, 0, 0, 0, 1), ("cn", 64, 1, 1, 0, 0, 0, 1)],
            [("uib", 96, 2, 0, 3.0, 5, 5, 1), ("uib", 96, 1, 0, 2.0, 0, 3, 4),
             ("uib", 96, 1, 0, 4.0, 3, 0, 1)],
            [("uib", 128, 2, 0, 6.0, 3, 3, 1), ("uib", 128, 1, 0, 4.0, 5, 5, 1),
             ("uib", 128, 1, 0, 4.0, 0, 5, 1), ("uib", 128, 1, 0, 3.0, 0, 5, 1),
             ("uib", 128, 1, 0, 4.0, 0, 3, 2)],
        ],
        head=960,
    ),
    "medium": dict(
        stem=32,
        stages=[
            [("er", 48, 2, 3, 4.0, 0, 0, 1)],
            [("uib", 80, 2, 0, 4.0, 3, 5, 1), ("uib", 80, 1, 0, 2.0, 3, 3, 1)],
            [("uib", 160, 2, 0, 6.0, 3, 5, 1), ("uib", 160, 1, 0, 4.0, 3, 3, 2),
             ("uib", 160, 1, 0, 4.0, 3, 5, 1), ("uib", 160, 1, 0, 4.0, 3, 3, 1),
             ("uib", 160, 1, 0, 4.0, 3, 0, 1), ("uib", 160, 1, 0, 2.0, 0, 0, 1),
             ("uib", 160, 1, 0, 4.0, 3, 0, 1)],
            [("uib", 256, 2, 0, 6.0, 5, 5, 1), ("uib", 256, 1, 0, 4.0, 5, 5, 1),
             ("uib", 256, 1, 0, 4.0, 3, 5, 2), ("uib", 256, 1, 0, 4.0, 0, 0, 1),
             ("uib", 256, 1, 0, 4.0, 3, 0, 1), ("uib", 256, 1, 0, 2.0, 3, 5, 1),
             ("uib", 256, 1, 0, 4.0, 5, 5, 1), ("uib", 256, 1, 0, 4.0, 0, 0, 2),
             ("uib", 256, 1, 0, 2.0, 5, 0, 1)],
        ],
        head=960,
    ),
    "large": dict(
        stem=24,
        stages=[
            [("er", 48, 2, 3, 4.0, 0, 0, 1)],
            [("uib", 96, 2, 0, 4.0, 3, 5, 1), ("uib", 96, 1, 0, 4.0, 3, 3, 1)],
            [("uib", 192, 2, 0, 4.0, 3, 5, 1), ("uib", 192, 1, 0, 4.0, 3, 3, 3),
             ("uib", 192, 1, 0, 4.0, 3, 5, 1), ("uib", 192, 1, 0, 4.0, 5, 3, 5),
             ("uib", 192, 1, 0, 4.0, 3, 0, 1)],
            [("uib", 512, 2, 0, 4.0, 5, 5, 1), ("uib", 512, 1, 0, 4.0, 5, 5, 3),
             ("uib", 512, 1, 0, 4.0, 5, 0, 1), ("uib", 512, 1, 0, 4.0, 5, 3, 1),
             ("uib", 512, 1, 0, 4.0, 5, 0, 2), ("uib", 512, 1, 0, 4.0, 5, 3, 1),
             ("uib", 512, 1, 0, 4.0, 5, 5, 1), ("uib", 512, 1, 0, 4.0, 5, 0, 3)],
        ],
        head=960,
    ),
}


def unroll_spec(spec: dict) -> dict:
    """One row per block: a row's repeats become rows of one repeat, the
    row's stride on the first of them only."""
    stages = [[(kind, out_ch, stride if r == 0 else 1, kernel, expand, dws, dwm, 1)
               for kind, out_ch, stride, kernel, expand, dws, dwm, repeats in stage
               for r in range(repeats)]
              for stage in spec["stages"]]
    return dict(stem=spec["stem"], stages=stages, head=spec["head"])


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)


class ConvNorm(nn.Module):
    """A UIB child (timm ConvNormAct): ``conv`` and ``bn``, ReLU with ``act``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, groups)
        self.bn = _bn(cout)
        self.act = act

    def forward(self, x):
        h = self.bn(self.conv(x))
        return F.relu(h) if self.act else h


class ConvBnAct(nn.Module):
    """timm ConvBnAct: ``conv``, ``bn1``, ReLU (JAX ``ConvBN``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride)
        self.bn1 = _bn(cout)

    def forward(self, x):
        return F.relu(self.bn1(self.conv(x)))


class EdgeResidual(nn.Module):
    """Fused inverted residual: k x k expand, BN, ReLU, 1x1 project, BN; the
    input added when the stride is 1 and the width kept."""

    def __init__(self, cin: int, cout: int, expand: float, k: int, stride: int):
        super().__init__()
        mid = int(cin * expand)
        self.conv_exp = _conv(cin, mid, k, stride)
        self.bn1 = _bn(mid)
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn2 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        h = self.bn2(self.conv_pwl(F.relu(self.bn1(self.conv_exp(x)))))
        return h + x if self.has_skip else h


class UIB(nn.Module):
    """Universal inverted residual: [depthwise ``dw_start``, no activation],
    1x1 expand (ReLU), [depthwise ``dw_mid`` (ReLU)], 1x1 project; the
    stride on ``dw_mid`` when there is one, else on ``dw_start``."""

    def __init__(self, cin: int, cout: int, expand: float, stride: int, dw_start: int,
                 dw_mid: int):
        super().__init__()
        mid = int(cin * expand)
        self.dw_start = ConvNorm(cin, cin, dw_start, 1 if dw_mid else stride, cin,
                                 act=False) if dw_start else None
        self.pw_exp = ConvNorm(cin, mid, 1)
        self.dw_mid = ConvNorm(mid, mid, dw_mid, stride, mid) if dw_mid else None
        self.pw_proj = ConvNorm(mid, cout, 1, act=False)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        h = x if self.dw_start is None else self.dw_start(x)
        h = self.pw_exp(h)
        if self.dw_mid is not None:
            h = self.dw_mid(h)
        h = self.pw_proj(h)
        return h + x if self.has_skip else h


class MobileNetV4Features(nn.Module):
    """Five taps, highest resolution first: the stem (/2), the ends of the
    first three stages (/4, /8, /16) and the 1x1 head after the fourth
    (/32). ``spec`` (``MNV4_SPECS``' format, e.g. derived from a checkpoint
    by the JAX package's ``convert_timm_mnv4``) overrides ``variant``'s
    layout. ``channels``: the taps' widths."""

    def __init__(self, variant: str = "small", in_ch: int = 3, spec: dict | None = None):
        super().__init__()
        spec = unroll_spec(spec if spec is not None else MNV4_SPECS[variant])
        self.conv_stem = _conv(in_ch, spec["stem"], 3, 2)
        self.bn1 = _bn(spec["stem"])
        stages, cin, self.channels = [], spec["stem"], [spec["stem"]]
        for si, stage in enumerate(spec["stages"]):
            blocks = []
            for kind, cout, stride, k, expand, dws, dwm, _ in stage:
                if kind == "cn":
                    blocks.append(ConvBnAct(cin, cout, k, stride))
                elif kind == "er":
                    blocks.append(EdgeResidual(cin, cout, expand, k, stride))
                else:
                    blocks.append(UIB(cin, cout, expand, stride, dws, dwm))
                cin = cout
            stages.append(nn.ModuleList(blocks))
            if si < len(spec["stages"]) - 1:
                self.channels.append(cin)
        stages.append(nn.ModuleList([ConvBnAct(cin, spec["head"], 1)]))
        self.channels.append(spec["head"])
        self.blocks = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.relu(self.bn1(self.conv_stem(x)))
        feats = [h]
        for stage in self.blocks:
            for blk in stage:
                h = blk(h)
            feats.append(h)
        # the fourth stage runs into the head untapped
        return feats[:4] + feats[5:]
