"""K11: canny non-maximum suppression, the counterpart of
``patchrefinerv2_tpu/ops/canny.py`` (``canny_nms`` :14), and K12: the
bounded hysteresis of the training losses' canny
(``patchrefinerv2_tpu/models/losses_extra.py:129-134``, ``_dilate3x3`` :81).

skimage.feature.canny's bilinear-interpolated NMS over the four gradient
sectors: a pixel is a local maximum when its magnitude is ``>=`` both
neighbours interpolated along its gradient (zero outside the map). The
result is not yet restricted to the eroded mask or a nonzero magnitude:
callers apply their own conventions (``evaluation/metrics.canny``).

On a CUDA tensor :func:`canny_nms` launches ``csrc/canny.cu`` (float32 or
float64) or raises; on a CPU tensor it runs :func:`canny_nms_plain`, a
line-by-line transcription of the reference. ``canny_nms.launches`` counts
the kernel launches.

:func:`hysteresis_bounded` grows a high mask inside a low mask by ``steps``
3x3 dilations (zero outside the map), each ANDed with the low mask: JAX's
``fori_loop``, which reaches at most ``steps`` pixels along a weak chain. On
a CUDA tensor it launches ``csrc/hysteresis.cu`` or raises; on a CPU tensor
it runs :func:`hysteresis_bounded_plain`. It takes bool masks, which carry
no gradient. ``hysteresis_bounded.launches`` counts the calls that launch
the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops import _cuda

__all__ = ["canny_nms", "canny_nms_plain", "hysteresis_bounded", "hysteresis_bounded_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def canny_nms_plain(isobel, jsobel, magnitude):
    """Plain PyTorch version of :func:`canny_nms` (any device), in the
    reference's order of operations."""
    h, w = magnitude.shape[-2], magnitude.shape[-1]
    pm = F.pad(magnitude, (1, 1, 1, 1))

    def nb(di, dj):
        return pm[..., 1 + di:1 + di + h, 1 + dj:1 + dj + w]

    eps = 1e-12
    abs_i, abs_j = isobel.abs(), jsobel.abs()
    same_sign = (isobel * jsobel) >= 0
    local_maxima = torch.zeros(magnitude.shape, dtype=torch.bool, device=magnitude.device)

    horiz = abs_j >= abs_i
    wgt = abs_i / (abs_j + eps)
    for sgn, diag in ((same_sign, 1), (~same_sign, -1)):
        sel = horiz & sgn
        c_plus = nb(diag, 1) * wgt + nb(0, 1) * (1 - wgt)
        c_minus = nb(-diag, -1) * wgt + nb(0, -1) * (1 - wgt)
        local_maxima = local_maxima | (sel & (magnitude >= c_plus) & (magnitude >= c_minus))

    vert = ~horiz
    wgt = abs_j / (abs_i + eps)
    for sgn, diag in ((same_sign, 1), (~same_sign, -1)):
        sel = vert & sgn
        c_plus = nb(1, diag) * wgt + nb(1, 0) * (1 - wgt)
        c_minus = nb(-1, -diag) * wgt + nb(-1, 0) * (1 - wgt)
        local_maxima = local_maxima | (sel & (magnitude >= c_plus) & (magnitude >= c_minus))
    return local_maxima


def canny_nms(isobel: torch.Tensor, jsobel: torch.Tensor, magnitude: torch.Tensor) -> torch.Tensor:
    """Local-maxima mask (bool, the shape of ``magnitude``) of the (..., H, W)
    gradients ``isobel`` (along H), ``jsobel`` (along W) and their
    ``magnitude``, all float32 or all float64."""
    if magnitude.ndim < 2 or isobel.shape != magnitude.shape or jsobel.shape != magnitude.shape:
        raise ValueError(f"expected three (..., H, W) maps of one shape, got {tuple(isobel.shape)}, "
                         f"{tuple(jsobel.shape)}, {tuple(magnitude.shape)}")
    if _cuda.on_cpu(magnitude):
        return canny_nms_plain(isobel, jsobel, magnitude)
    if not (isobel.dtype == jsobel.dtype == magnitude.dtype) or magnitude.dtype not in _DTYPE_CODES:
        raise TypeError(f"canny_nms takes float32 or float64 maps of one dtype, got "
                        f"{isobel.dtype}, {jsobel.dtype}, {magnitude.dtype}")
    _cuda.require_cuda(isobel, jsobel, magnitude)
    h, w = magnitude.shape[-2:]
    out = torch.empty(magnitude.shape, dtype=torch.bool, device=magnitude.device)
    fn = _cuda.bind("canny", "prv2_canny_nms", 4, 3)
    rc = fn(_cuda.ptr(isobel), _cuda.ptr(jsobel), _cuda.ptr(magnitude), _cuda.ptr(out),
            magnitude.numel() // (h * w) if h * w else 0, h, w, _DTYPE_CODES[magnitude.dtype],
            _cuda.stream_of(magnitude))
    _cuda.check(rc, "canny_nms")
    canny_nms.launches += 1
    return out


canny_nms.launches = 0


def hysteresis_bounded_plain(low: torch.Tensor, high: torch.Tensor, steps: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`hysteresis_bounded` (any device):
    ``steps`` times a 3x3 max-pool of the mask (its padding never wins, so
    the border is zero) ANDed with ``low``."""
    h, w = high.shape[-2], high.shape[-1]
    out = high.clone()
    for _ in range(steps):
        grown = F.max_pool2d(out.reshape(-1, 1, h, w).float(), 3, 1, 1).reshape(high.shape) > 0
        out = low & grown
    return out


def hysteresis_bounded(low: torch.Tensor, high: torch.Tensor, steps: int = 128) -> torch.Tensor:
    """``out = high``, then ``steps`` times ``out = low & dilate3x3(out)``
    with zeros outside the map, over bool (..., H, W) masks of one shape.
    No early exit: every step runs, as in JAX."""
    if low.ndim < 2 or low.shape != high.shape:
        raise ValueError(f"expected two (..., H, W) masks of one shape, got {tuple(low.shape)}, "
                         f"{tuple(high.shape)}")
    if low.dtype != torch.bool or high.dtype != torch.bool:
        raise TypeError(f"hysteresis_bounded takes bool masks, got {low.dtype}, {high.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if _cuda.on_cpu(low):
        return hysteresis_bounded_plain(low, high, steps)
    _cuda.require_cuda(low, high)
    if steps == 0 or low.numel() == 0:
        return high.clone()
    h, w = low.shape[-2:]
    out, tmp = torch.empty_like(high), torch.empty_like(high)
    fn = _cuda.bind("hysteresis", "prv2_hysteresis_bounded", 4, 4)
    rc = fn(_cuda.ptr(low), _cuda.ptr(high), _cuda.ptr(out), _cuda.ptr(tmp), low.numel() // (h * w),
            h, w, steps, 0, _cuda.stream_of(low))
    _cuda.check(rc, "hysteresis_bounded")
    hysteresis_bounded.launches += 1
    return out


hysteresis_bounded.launches = 0
