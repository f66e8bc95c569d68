"""Host augmentations and the host resize of the readers, the port of
``patchrefinerv2_tpu/datasets/transforms.py``. Images are (H, W, C) numpy
arrays, depths (H, W). The draws come from Python's ``random`` and numpy's
global RNG in the JAX package's order, so that seeding both alike before a
sample gives the JAX package's sample."""

from __future__ import annotations

import random

import numpy as np

from patchrefinerv2_torch.datasets import native
from patchrefinerv2_torch.ops.resize import axis_taps


def aug_flip(image: np.ndarray, depths: list):
    """A horizontal flip of the image and every depth (``None`` kept) with
    probability one half."""
    if random.random() > 0.5:
        image = image[:, ::-1, :].copy()
        depths = [d[:, ::-1].copy() if d is not None else None for d in depths]
    return image, depths


def aug_color(image: np.ndarray, brightness_range=(0.9, 1.1)) -> np.ndarray:
    """With probability one half: a gamma in (0.9, 1.1), a brightness and a
    factor per colour, clipped to [0, 1], in the image's dtype."""
    if random.random() > 0.5:
        gamma = random.uniform(0.9, 1.1)
        out = image ** gamma
        out = out * random.uniform(*brightness_range)
        colors = np.random.uniform(0.9, 1.1, size=3)
        out = out * colors[None, None, :]
        image = np.clip(out, 0, 1).astype(image.dtype)
    return image


def aug_rotate(image: np.ndarray, depths: list, degree: float):
    """A rotation by an angle in (-degree, degree) about the centre, PIL's:
    bilinear for the (uint8) image, nearest for each depth (``None`` kept)."""
    from PIL import Image

    angle = (random.random() - 0.5) * 2 * degree
    image = np.asarray(Image.fromarray(image).rotate(angle, resample=Image.BILINEAR)).copy()
    out = [None if d is None else
           np.asarray(Image.fromarray(d).rotate(angle, resample=Image.NEAREST)).copy()
           for d in depths]
    return image, out


def random_crop(image: np.ndarray, depths: list, crop_size):
    """One random ``crop_size`` crop of the image and of every depth;
    returns (image, depths, (h start, w start))."""
    h, w = image.shape[:2]
    hs = random.randint(0, h - crop_size[0])
    ws = random.randint(0, w - crop_size[1])
    ch, cw = crop_size
    image = image[hs:hs + ch, ws:ws + cw].copy()
    depths = [d[hs:hs + ch, ws:ws + cw].copy() if d is not None else None for d in depths]
    return image, depths, (hs, ws)


def crop_bbox(ws: int, hs: int, patch_raw_shape, image_raw_shape, network_process_size,
              pre_norm_bbox: bool) -> np.ndarray:
    """A crop's (x0, y0, x1, y1) in raw pixels, or with ``pre_norm_bbox``
    in the process frame (each coordinate / raw size * process size)."""
    (ph, pw), (rh, rw), (nh, nw) = patch_raw_shape, image_raw_shape, network_process_size
    if pre_norm_bbox:
        return np.asarray([ws / rw * nw, hs / rh * nh, (ws + pw) / rw * nw, (hs + ph) / rh * nh],
                          np.float32)
    return np.asarray([ws, hs, ws + pw, hs + ph], np.float32)


def resize_hwc(image: np.ndarray, size, mode: str = "bilinear", align_corners: bool = True) -> np.ndarray:
    """``F.interpolate``'s resize of an (H, W, C) or (H, W) array, float32:
    bilinear with align_corners on an (H, W, C) array by the host library,
    every other case by ``axis_taps`` summed in float64, one axis after the
    other."""
    if mode == "bilinear" and align_corners and image.ndim == 3:
        return native.resize_bilinear_ac(image, size)
    x = image.astype(np.float64)
    for axis, n in enumerate(size):
        idx, w = axis_taps(x.shape[axis], int(n), mode, bool(align_corners))
        shape = [1] * x.ndim
        shape[axis] = int(n)
        x = sum(np.take(x, idx[t], axis) * w[t].astype(np.float64).reshape(shape)
                for t in range(idx.shape[0]))
    return x.astype(np.float32)
