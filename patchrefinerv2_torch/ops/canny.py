"""K11: canny non-maximum suppression, the counterpart of
``patchrefinerv2_tpu/ops/canny.py`` (``canny_nms`` :14).

skimage.feature.canny's bilinear-interpolated NMS over the four gradient
sectors: a pixel is a local maximum when its magnitude is ``>=`` both
neighbours interpolated along its gradient (zero outside the map). The
result is not yet restricted to the eroded mask or a nonzero magnitude:
callers apply their own conventions (``evaluation/metrics.canny``).

On a CUDA tensor :func:`canny_nms` launches ``csrc/canny.cu`` (float32 or
float64) or raises; on a CPU tensor it runs :func:`canny_nms_plain`, a
line-by-line transcription of the reference. ``canny_nms.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops import _cuda

__all__ = ["canny_nms", "canny_nms_plain"]

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
