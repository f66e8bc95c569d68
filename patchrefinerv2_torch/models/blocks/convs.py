"""Elementary conv blocks, the port of
``patchrefinerv2_tpu/models/blocks/convs.py`` (``SingleConvCNNLN`` :71,
``DoubleConv`` :126, ``ResidualConvUnit`` :197, ``gelu`` :51).

Modules carry NCHW tensors in ``torch.channels_last`` memory format
(physically NHWC); the ops take NHWC, so :func:`to_nhwc` is a free view.
Parameter names follow the reference's torch state dicts.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.ops.layer_norm import layer_norm
from patchrefinerv2_torch.ops.resize import resize


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> contiguous NHWC view (copies only when the
    tensor is not channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory format."""
    return x.permute(0, 3, 1, 2)


def interp(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear align_corners=True resize of an NCHW tensor (K2)."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    return to_nchw(resize(to_nhwc(x), size, "bilinear", True))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in float32, tanh GELU in bfloat16 (convs.py:51)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def conv3(cin: int, cout: int, bias: bool = True, k: int = 3) -> nn.Conv2d:
    """k x k stride-1 conv with symmetric k//2 padding (SAME)."""
    return nn.Conv2d(cin, cout, k, 1, k // 2, bias=bias)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels (eps 1e-6, float32 statistics) through K6."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if x.ndim == 4:
            return to_nchw(layer_norm(to_nhwc(x), self.weight, self.bias, self.eps, relu))
        return layer_norm(x, self.weight, self.bias, self.eps, relu)


class SingleConvCNNLN(nn.Module):
    """conv (no bias) -> channel LN -> GELU (reference convs.py:65-76)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.single_conv = nn.Sequential(
            conv3(cin, features, bias=False, k=kernel_size), ChannelLayerNorm(features), nn.GELU())

    def forward(self, x):
        return gelu(self.single_conv[1](self.single_conv[0](x)))


class DoubleConv(nn.Module):
    """(conv3x3 no-bias -> GELU) x 2 (reference convs.py:31-45)."""

    def __init__(self, cin: int, features: int, mid: int | None = None):
        super().__init__()
        mid = mid or features
        self.double_conv = nn.Sequential(
            conv3(cin, mid, bias=False), nn.GELU(), conv3(mid, features, bias=False), nn.GELU())

    def forward(self, x):
        return gelu(self.double_conv[2](gelu(self.double_conv[0](x))))


class ResidualConvUnit(nn.Module):
    """DPT residual unit: x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv3(features, features)
        self.conv2 = conv3(features, features)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x
