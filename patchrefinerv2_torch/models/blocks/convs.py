"""Elementary conv blocks, the port of
``patchrefinerv2_tpu/models/blocks/convs.py`` (``SingleConvCNNLN`` :71,
``DoubleConv`` :126, ``ResidualConvUnit`` :197, ``gelu`` :51).

Modules carry NCHW tensors in ``torch.channels_last`` memory format
(physically NHWC); the ops take NHWC, so :func:`to_nhwc` is a free view.
Parameter names follow the reference's torch state dicts. ``tail=True``
marks the fusion head's full-resolution instances, which the JAX package
runs in space-to-depth form (``s2d_split`` / ``s2d_out``): there the conv
and its epilogue are one K9 launch (``ops/tail_conv.py``). The convolutions
that the reference routes through its int8 dispatcher outside that tail are
int8 sites (``models/int8.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.int8 import int8_conv, mark_site
from patchrefinerv2_torch.ops.layer_norm import layer_norm
from patchrefinerv2_torch.ops.resize import resize
from patchrefinerv2_torch.ops.tail_conv import tail_conv


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            return to_nchw(layer_norm(to_nhwc(x), self.weight, self.bias, self.eps))
        return layer_norm(x, self.weight, self.bias, self.eps)


class SingleConvCNNLN(nn.Module):
    """conv (no bias) -> channel LN -> GELU (reference convs.py:65-76) over
    the channel concatenation of its inputs. ``tail``: one K9 launch that
    reads the inputs in place."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, tail: bool = False):
        super().__init__()
        self.tail = tail
        self.single_conv = nn.Sequential(
            conv3(cin, features, bias=False, k=kernel_size), ChannelLayerNorm(features), nn.GELU())
        if not tail:
            mark_site(self.single_conv[0], "qamax_0")

    def forward(self, *parts):
        conv, ln = self.single_conv[0], self.single_conv[1]
        if self.tail:
            return to_nchw(tail_conv([to_nhwc(p) for p in parts], conv.weight,
                                     ln=(ln.weight, ln.bias), act="gelu", eps=ln.eps))
        y = int8_conv(conv, parts)
        if y is None:
            y = conv(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1))
        return gelu(ln(y))


class DoubleConv(nn.Module):
    """(conv3x3 no-bias -> GELU) x 2 (reference convs.py:31-45). ``tail``:
    the second conv and its GELU are one K9 launch."""

    def __init__(self, cin: int, features: int, mid: int | None = None, tail: bool = False):
        super().__init__()
        mid = mid or features
        self.tail = tail
        self.double_conv = nn.Sequential(
            conv3(cin, mid, bias=False), nn.GELU(), conv3(mid, features, bias=False), nn.GELU())
        mark_site(self.double_conv[0], "qamax_0")
        if not tail:
            mark_site(self.double_conv[2], "qamax_1")

    def forward(self, x):
        c0, c1 = self.double_conv[0], self.double_conv[2]
        h = int8_conv(c0, [x])
        h = gelu(c0(x) if h is None else h)
        if self.tail:
            return to_nchw(tail_conv([to_nhwc(h)], c1.weight, act="gelu"))
        y = int8_conv(c1, [h])
        return gelu(c1(h) if y is None else y)


class ResidualConvUnit(nn.Module):
    """DPT residual unit: x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv3(features, features)
        self.conv2 = conv3(features, features)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x
