"""Gaussian boundary blend mask (host-side precompute, shape-static), the
port of ``patchrefinerv2_tpu/ops/masks.py`` (``generate_blend_mask`` :52).

Replicates the reference's ``generatemask`` (estimator/models/utils.py:51-60):
a box of ones inset by ``border`` of the patch size, blurred with a Gaussian
(sigma = h/16, kernel = 2*ceil(2*sigma)+1), then min-max normalized. Computed
once per (size, border) on host in numpy and fed to the device as a constant —
it never changes during a run.

cv2's GaussianBlur uses BORDER_REFLECT_101 padding and separable filtering;
it is reproduced in pure numpy, so the op layer has no cv2 dependency.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["generate_blend_mask", "gaussian_kernel_1d"]


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), normalized."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float64)


def _reflect101_pad_1d(x: np.ndarray, pad: int, axis: int) -> np.ndarray:
    return np.pad(
        x, [(pad, pad) if a == axis else (0, 0) for a in range(x.ndim)], mode="reflect"
    )


def _gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    k = gaussian_kernel_1d(ksize, sigma)
    pad = ksize // 2
    out = img.astype(np.float64)
    for axis in range(2):
        padded = _reflect101_pad_1d(out, pad, axis)
        out = np.apply_along_axis(
            lambda m: np.convolve(m, k[::-1], mode="valid"), axis, padded
        )
    return out


@functools.lru_cache(maxsize=None)
def generate_blend_mask(size: tuple[int, int], border: float = 0.1) -> np.ndarray:
    """Gaussian blend mask, float32 (H, W), values in [0, 1]."""
    h, w = int(size[0]), int(size[1])
    sigma = int(h / 16)
    ksize = int(2 * np.ceil(2 * int(h / 16)) + 1)
    mask = np.zeros((h, w), dtype=np.float64)
    bh, bw = int(border * h), int(border * w)
    mask[bh : h - bh, bw : w - bw] = 1.0
    mask = _gaussian_blur(mask, ksize, sigma)
    span = mask.max() - mask.min()
    if span <= 0:  # degenerate tiny patch: border inset rounds to zero
        return np.ones((h, w), dtype=np.float32)
    mask = (mask - mask.min()) / span
    return mask.astype(np.float32)
