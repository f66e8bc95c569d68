"""EfficientNet-B5 (``tf_efficientnet_b5_ap``, features_only) for the
lightweight refiner, the port of
``patchrefinerv2_tpu/models/backbones/encoders.py`` (``SqueezeExcite`` :78,
``MBConv`` :93, ``EfficientNetB5Features`` :166).

timm's module layout and key names: ``conv_stem``/``bn1``, then
``blocks.{stage}.{block}``; stage 0 (expansion 1) holds depthwise-separable
blocks (``conv_dw``, ``bn1``, ``se``, ``conv_pw``, ``bn2``), the others
inverted residuals (``conv_pw``, ``bn1``, ``conv_dw``, ``bn2``, ``se``,
``conv_pwl``, ``bn3``). TF-SAME padding (asymmetric for stride 2), SiLU,
squeeze-excite over a quarter of the block input, BatchNorm with eps 1e-3
(:class:`BatchNorm`: flax's train mode, whose running statistics update once
a step). ``in_ch=4`` is the coarse-depth-conditioned stem. The 1x1 convs
that the reference routes through its int8 dispatcher (``pconv``,
encoders.py:122-146) are int8 sites (``models/int8.py``): ``conv_pw`` and
``conv_pwl`` of an inverted residual, ``conv_pw`` of a depthwise-separable
block (the reference's ``conv_pwl`` of an expand-1 MBConv).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.int8 import int8_conv, mark_site

# (kernel, stride, expand, out_ch, repeats): B0 scaled by width 1.6 / depth 2.2
EFFB5_STAGES = [
    (3, 1, 1, 24, 3), (3, 2, 6, 40, 5), (5, 2, 6, 64, 5), (3, 2, 6, 128, 7),
    (5, 1, 6, 176, 7), (5, 2, 6, 304, 9), (3, 1, 6, 512, 3),
]
EFFB5_TAPS = (0, 1, 2, 4, 6)
EFFB5_CHANNELS = [24, 40, 64, 176, 512]
# the encoder's pretraining normalisation (tf_efficientnet_b5_ap)
EFFB5_MEAN = (0.5, 0.5, 0.5)
EFFB5_STD = (0.5, 0.5, 0.5)


class Conv2dSame(nn.Conv2d):
    """TF SAME padding: total pad max((ceil(in/s) - 1) * s + k - in, 0), the
    smaller half before."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph = max((-(-ih // sh) - 1) * sh + kh - ih, 0)
        pw = max((-(-iw // sw) - 1) * sw + kw - iw, 0)
        if ph or pw:
            x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def _pconv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 int8 site: the int8 conv where it is served, else the exact one."""
    y = int8_conv(conv, [x])
    return conv(x) if y is None else y


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's ``nn.BatchNorm`` (momentum 0.9) in
    train mode (encoders.py:55-74): the batch is normalised with its own
    float32 moments, and the running statistics move by ``ra = 0.9 ra + 0.1
    batch`` with the *biased* batch variance ``max(E[x^2] - mean^2, 0)``
    (``nn.BatchNorm2d`` uses the unbiased one). The running update happens
    only in a forward armed by :func:`arm_stat_updates` and only once: the
    counterpart of flax's ``mutable=["batch_stats"]``, and the guard that
    keeps a rematerialised forward (``torch.utils.checkpoint`` runs the
    forward again in the backward) from updating twice. Eval mode uses the
    running statistics."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__(c, eps=eps, momentum=0.1)
        self.armed = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.armed:
            self.armed = False
            with torch.no_grad():
                xf = x.to(torch.promote_types(x.dtype, torch.float32))
                mean = xf.mean((0, 2, 3))
                var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def arm_stat_updates(module: nn.Module) -> None:
    """Let each :class:`BatchNorm` of ``module`` update its running
    statistics in its next train-mode forward, once."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.armed = True


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, ch, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, se_red: int):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, stride, 0, groups=cin, bias=False)
        self.bn1 = _bn(cin)
        self.se = SqueezeExcite(cin, se_red)
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout
        mark_site(self.conv_pw, "qamax_0")

    def forward(self, x):
        h = self.se(F.silu(self.bn1(self.conv_dw(x))))
        h = self.bn2(_pconv(self.conv_pw, h))
        return h + x if self.has_skip else h


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, k: int, stride: int, se_red: int):
        super().__init__()
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, 0, groups=mid, bias=False)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, se_red)
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout
        mark_site(self.conv_pw, "qamax_0")
        mark_site(self.conv_pwl, "qamax_1")

    def forward(self, x):
        h = F.silu(self.bn1(_pconv(self.conv_pw, x)))
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(_pconv(self.conv_pwl, h))
        return h + x if self.has_skip else h


class EfficientNetB5Features(nn.Module):
    """tf_efficientnet_b5_ap features_only: taps after stages 0, 1, 2, 4, 6
    (channels [24, 40, 64, 176, 512], strides 2..32)."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.conv_stem = Conv2dSame(in_ch, 48, 3, 2, 0, bias=False)
        self.bn1 = _bn(48)
        stages, cin = [], 48
        for k, s, e, c, r in EFFB5_STAGES:
            blocks = []
            for bi in range(r):
                stride = s if bi == 0 else 1
                se_red = max(1, int(cin * 0.25))
                if e == 1:
                    blocks.append(DepthwiseSeparable(cin, c, k, stride, se_red))
                else:
                    blocks.append(InvertedResidual(cin, cin * e, c, k, stride, se_red))
                cin = c
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_stem(x)))
        feats = []
        for si, stage in enumerate(self.blocks):
            for blk in stage:
                h = blk(h)
            if si in EFFB5_TAPS:
                feats.append(h)
        return feats
