"""K2: resize with exact ``F.interpolate`` semantics, and crop + resize.

Counterpart of ``patchrefinerv2_tpu/ops/resize.py`` (``resize`` :214,
``resize_matrix`` :106) and ``models/tiling.py:229``
(``crop_resize_patches``). The TPU version contracts dense interpolation
matrices on the MXU; here each axis becomes its taps (two source indices
and two weights per output index, one tap for nearest), computed on the
host in float32 exactly as ``_resize_matrix_np`` does, and the CUDA kernel
``csrc/resize.cu`` gathers them. Layout: NHWC at every public function.

On a CUDA tensor the functions launch the kernel (or raise); on a CPU
tensor they run the plain PyTorch version, which applies the same taps
with indexing. ``resize.launches`` and ``crop_resize.launches`` count the
kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from patchrefinerv2_torch.ops import _cuda

__all__ = ["axis_taps", "resize", "resize_plain", "crop_resize", "crop_resize_plain"]


@functools.lru_cache(maxsize=None)
def axis_taps(in_size: int, out_size: int, mode: str, align_corners: bool):
    """(idx (2, out) int32, w (2, out) float32): output i = w[0,i]*x[idx[0,i]]
    + w[1,i]*x[idx[1,i]]. Source coordinates in float32 as torch computes
    them (the reference's ``_resize_matrix_np``, resize.py:29-104)."""
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"resize mode {mode!r} is not ported (bilinear, nearest)")
    idx = np.zeros((2, out_size), np.int32)
    w = np.zeros((2, out_size), np.float32)
    if in_size == out_size and mode != "nearest":
        idx[0] = idx[1] = np.arange(out_size)
        w[0] = 1.0
        return idx, w
    dst = np.arange(out_size, dtype=np.float32)
    if mode == "nearest":
        scale = np.float32(in_size / out_size)
        src = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        idx[0] = idx[1] = src
        w[0] = 1.0
        return idx, w
    if align_corners:
        scale = np.float32((in_size - 1) / (out_size - 1)) if out_size > 1 else np.float32(0.0)
        src = (dst * scale).astype(np.float32)
    else:
        scale = np.float32(in_size / out_size)
        src = ((dst + np.float32(0.5)) * scale - np.float32(0.5)).astype(np.float32)
        src = np.maximum(src, np.float32(0.0))
    src = src.astype(np.float64)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    idx[0], idx[1] = lo, hi
    w[0], w[1] = (1.0 - frac).astype(np.float32), frac.astype(np.float32)
    return idx, w


@functools.lru_cache(maxsize=256)
def _taps_on(in_size, out_size, mode, align_corners, device):
    idx, w = axis_taps(in_size, out_size, mode, align_corners)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def _apply_axis(x, axis, idx, w):
    """Combine the two taps along ``axis`` of a float32 tensor."""
    shape = [1] * x.ndim
    shape[axis] = -1
    a = x.index_select(axis, idx[0].long()) * w[0].view(shape)
    return a + x.index_select(axis, idx[1].long()) * w[1].view(shape)


def resize_plain(x, size, mode="bilinear", align_corners=False):
    """Plain PyTorch version of :func:`resize` (any device)."""
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    dev = x.device
    iy, wy = _taps_on(h, oh, mode, bool(align_corners), dev)
    ix, wx = _taps_on(w, ow, mode, bool(align_corners), dev)
    y = _apply_axis(x.float(), 1, iy, wy)
    y = _apply_axis(y, 2, ix, wx)
    return y.to(x.dtype)


def resize(x: torch.Tensor, size, mode: str = "bilinear", align_corners: bool = False):
    """Resize NHWC ``x`` (or HWC) to ``size=(H, W)`` as
    ``F.interpolate(x_nchw, size, mode, align_corners)`` does. Bicubic and
    ``scale_override`` are not ported."""
    if x.ndim == 3:
        return resize(x[None], size, mode, align_corners)[0]
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    axis_taps(h, oh, mode, bool(align_corners))  # validates the mode
    if (h, w) == (oh, ow) and mode != "nearest":
        return x
    if _cuda.on_cpu(x):
        return resize_plain(x, size, mode, align_corners)
    _cuda.require_cuda(x)
    dt = _cuda.dtype_code(x.dtype)
    iy, wy = _taps_on(h, oh, mode, bool(align_corners), x.device)
    ix, wx = _taps_on(w, ow, mode, bool(align_corners), x.device)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    fn = _cuda.bind("resize", "prv2_resize", 7, 7)
    rc = fn(_cuda.ptr(x), _cuda.ptr(y), _cuda.ptr(iy), _cuda.ptr(wy), _cuda.ptr(ix),
            _cuda.ptr(wx), _cuda.ptr(None), n, h, w, c, oh, ow, h * w * c, dt, _cuda.stream_of(x))
    _cuda.check(rc, "resize")
    resize.launches += 1
    return y


resize.launches = 0


def crop_resize_plain(image, starts, patch_raw_shape, out_shape):
    """Plain PyTorch version of :func:`crop_resize` (any device)."""
    prh, prw = patch_raw_shape
    st = starts.to("cpu").tolist()
    patches = torch.stack([image[h:h + prh, w:w + prw] for h, w in st])
    return resize_plain(patches, out_shape, "bilinear", True)


def crop_resize(image: torch.Tensor, starts: torch.Tensor, patch_raw_shape, out_shape):
    """Crop N patches of ``patch_raw_shape`` from the (H, W, C) ``image`` at
    ``starts`` (N, 2) int32 [h, w] and resize each to ``out_shape`` with
    bilinear, align_corners=True (the MiDaS resizer, tiling.py:235-240), in
    the image's dtype. A crop reaching outside the image raises on the CPU
    and gives zeros from the kernel."""
    if image.ndim != 3:
        raise ValueError(f"expected an (H, W, C) image, got {tuple(image.shape)}")
    if starts.ndim != 2 or starts.shape[1] != 2:
        raise ValueError(f"expected (N, 2) starts, got {tuple(starts.shape)}")
    prh, prw = int(patch_raw_shape[0]), int(patch_raw_shape[1])
    oh, ow = int(out_shape[0]), int(out_shape[1])
    if _cuda.on_cpu(image):
        return crop_resize_plain(image, starts, (prh, prw), (oh, ow))
    starts = starts.to(device=image.device, dtype=torch.int32).contiguous()
    _cuda.require_cuda(image, starts)
    dt = _cuda.dtype_code(image.dtype)
    h, w, c = image.shape
    n = starts.shape[0]
    iy, wy = _taps_on(prh, oh, "bilinear", True, image.device)
    ix, wx = _taps_on(prw, ow, "bilinear", True, image.device)
    y = torch.empty((n, oh, ow, c), dtype=image.dtype, device=image.device)
    fn = _cuda.bind("resize", "prv2_resize", 7, 7)
    rc = fn(_cuda.ptr(image), _cuda.ptr(y), _cuda.ptr(iy), _cuda.ptr(wy), _cuda.ptr(ix),
            _cuda.ptr(wx), _cuda.ptr(starts), n, h, w, c, oh, ow, 0, dt, _cuda.stream_of(image))
    _cuda.check(rc, "crop_resize")
    crop_resize.launches += 1
    return y


crop_resize.launches = 0
