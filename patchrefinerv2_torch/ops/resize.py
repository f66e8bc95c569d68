"""K2: resize with exact ``F.interpolate`` semantics, and crop + resize.

Counterpart of ``patchrefinerv2_tpu/ops/resize.py`` (``resize`` :214,
``resize_matrix`` :106) and ``models/tiling.py:229``
(``crop_resize_patches``). The TPU version contracts dense interpolation
matrices on the MXU; here each axis becomes its taps (two source indices
and two weights per output index for bilinear and nearest, four for
bicubic), computed on the host in float32 exactly as ``_resize_matrix_np``
does, and the CUDA kernel ``csrc/resize.cu`` gathers them, one block per
output row segment. :func:`_launch_plan` picks the kernel's path on the
host: channel vectors of one pixel, or runs of consecutive elements of a
row for narrow or unaligned maps. Layout: NHWC at every public function.

On a CUDA tensor the functions launch the kernel (or raise); on a CPU
tensor they run the plain PyTorch version, which applies the same taps
with indexing. ``resize.launches`` and ``crop_resize.launches`` count the
kernel launches.

Under autograd a bilinear or bicubic :func:`resize` is a
``torch.autograd.Function`` (``_Resize``): the forward as above; the
backward of bilinear is ``aten.upsample_bilinear2d_backward``, the
transpose of the same taps (torch computes them as ``axis_taps`` does),
that of bicubic is the transpose of ``axis_taps``' own four taps an axis
(``resize_transpose``: each tap's weighted gradient added back into its
source index), the DINOv2 position embedding's ``scale_override`` included.
Nearest and :func:`crop_resize` raise when asked for a gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops._grad import forbid_grad, require_float, wants_grad, wide

__all__ = ["axis_taps", "resize", "resize_plain", "resize_transpose", "crop_resize",
           "crop_resize_plain"]

# bytes a thread of the kernel loads or stores at once, widest first
_VECTOR_BYTES = (16, 8, 4)


def _launch_plan(c: int, itemsize: int, align: int, out_row_bytes: int) -> tuple[int, bool]:
    """The kernel's path for ``c`` channels of ``itemsize`` bytes, a source
    whose pointer is ``align``-byte aligned and output rows of
    ``out_row_bytes`` (the output is a fresh allocation): ``(vec, False)``
    with ``vec`` >= 2, the channel path, each thread ``vec`` channels of one
    pixel in the widest of 16, 8 and 4 bytes that divides the pixel's
    channels and the alignment; else ``(0, vstore)``, the run path, each
    thread 16 bytes of consecutive output elements of a row, stored as one
    vector when ``vstore`` (the rows are a multiple of 16 bytes)."""
    for nb in _VECTOR_BYTES:
        if nb >= 2 * itemsize and (c * itemsize) % nb == 0 and align % nb == 0:
            return nb // itemsize, False
    return 0, out_row_bytes % 16 == 0


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides ``t``'s address."""
    ptr = t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


def _launch(x, y, taps_h, taps_w, starts, n, h, w, c, batch_stride, nearest=False):
    """Launch the kernel on ``x`` (n images of h x w x c, ``batch_stride``
    elements apart) into the fresh NHWC ``y`` with the packed taps."""
    oh, ow = y.shape[1], y.shape[2]
    vec, vstore = _launch_plan(c, x.element_size(), _alignment(x), ow * c * x.element_size())
    taps = 1 if nearest else taps_h.shape[1] // 2  # distinct source taps an axis
    fn = _cuda.bind("resize", "prv2_resize", 5, 10)
    return fn(_cuda.ptr(x), _cuda.ptr(y), _cuda.ptr(taps_h), _cuda.ptr(taps_w), _cuda.ptr(starts),
              n, h, w, c, oh, ow, batch_stride, taps, vec, int(vstore),
              _cuda.dtype_code(x.dtype), _cuda.stream_of(x))


def _cubic(t: np.ndarray) -> np.ndarray:
    """Cubic convolution with A = -0.75 (torch's bicubic)."""
    a = -0.75
    at = np.abs(t)
    return np.where(at <= 1.0, ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0,
                    np.where(at < 2.0, (((at - 5.0) * at + 8.0) * at - 4.0) * a, 0.0))


@functools.lru_cache(maxsize=None)
def axis_taps(in_size: int, out_size: int, mode: str, align_corners: bool, scale=None):
    """(idx (T, out) int32, w (T, out) float32) with T = 4 taps for bicubic
    and 2 otherwise: output i = sum_t w[t, i] * x[idx[t, i]], indices in
    ascending order. Source coordinates in float32 as torch computes them;
    ``scale`` is an explicit ``scale_factor`` (torch then uses 1 / scale in
    place of in / out, align_corners off). The reference's
    ``_resize_matrix_np`` (resize.py:29-104)."""
    if mode not in ("bilinear", "nearest", "bicubic"):
        raise NotImplementedError(f"resize mode {mode!r} is not ported (bilinear, nearest, bicubic)")
    n_taps = 4 if mode == "bicubic" else 2
    idx = np.zeros((n_taps, out_size), np.int32)
    w = np.zeros((n_taps, out_size), np.float32)
    if in_size == out_size and mode != "nearest":
        idx[:] = np.arange(out_size)
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
        step = np.float32((in_size - 1) / (out_size - 1)) if out_size > 1 else np.float32(0.0)
        src = (dst * step).astype(np.float32)
    else:
        step = np.float32(1.0 / scale) if scale else np.float32(in_size / out_size)
        src = ((dst + np.float32(0.5)) * step - np.float32(0.5)).astype(np.float32)
        if mode != "bicubic":  # torch clamps the source index at 0 for linear modes only
            src = np.maximum(src, np.float32(0.0))
    src = src.astype(np.float64)
    if mode == "bicubic":
        base = np.floor(src).astype(np.int64)
        frac = src - base
        for t in range(4):
            idx[t] = np.clip(base + t - 1, 0, in_size - 1)
            w[t] = _cubic(t - 1 - frac).astype(np.float32)
        return idx, w
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    idx[0], idx[1] = lo, hi
    w[0], w[1] = (1.0 - frac).astype(np.float32), frac.astype(np.float32)
    return idx, w


@functools.lru_cache(maxsize=256)
def _taps_on(in_size, out_size, mode, align_corners, scale, device):
    idx, w = axis_taps(in_size, out_size, mode, align_corners, scale)
    # cached for every later call: made outside inference mode, so that a
    # first call under ``torch.inference_mode`` (``infer``) does not hand
    # inference tensors to a later autograd graph
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=256)
def _packed_taps_on(in_size, out_size, mode, align_corners, scale, device):
    """The kernel's taps of an axis: (out, 2 T) int32, per output index its
    T source indices and then its T float32 weights' bits."""
    idx, w = axis_taps(in_size, out_size, mode, align_corners, scale)
    packed = np.concatenate([idx.T, np.ascontiguousarray(w.T).view(np.int32)], axis=1)
    return torch.from_numpy(np.ascontiguousarray(packed)).to(device)


def _apply_axis(x, axis, idx, w):
    """Combine the taps along ``axis`` of a float32 tensor."""
    shape = [1] * x.ndim
    shape[axis] = -1
    out = x.index_select(axis, idx[0].long()) * w[0].view(shape)
    for t in range(1, idx.shape[0]):
        out = out + x.index_select(axis, idx[t].long()) * w[t].view(shape)
    return out


def _scatter_axis(g, axis, size, idx, w):
    """The transpose of :func:`_apply_axis`: each tap's weighted ``g`` added
    into its source index along ``axis``, which gets ``size`` entries."""
    shape = [1] * g.ndim
    shape[axis] = -1
    out_shape = list(g.shape)
    out_shape[axis] = size
    out = g.new_zeros(out_shape)
    for t in range(idx.shape[0]):
        out.index_add_(axis, idx[t].long(), g * w[t].to(g.dtype).view(shape))
    return out


def resize_transpose(gy, in_hw, mode="bicubic", align_corners=False, scale_override=None):
    """The gradient of :func:`resize` (``mode``, ``align_corners``,
    ``scale_override``) from an (N, h, w, C) NHWC ``in_hw`` input for the
    output gradient ``gy`` (N, H, W, C): the transpose of the forward's
    taps, in ``gy``'s compute dtype (float32, or float64 on the CPU), in
    PyTorch ops on any device."""
    h, w = int(in_hw[0]), int(in_hw[1])
    oh, ow = gy.shape[1:3]
    sh, sw = _scales(scale_override)
    iy, wy = _taps_on(h, oh, mode, bool(align_corners), sh, gy.device)
    ix, wx = _taps_on(w, ow, mode, bool(align_corners), sw, gy.device)
    g = _scatter_axis(wide(gy), 2, w, ix, wx)
    return _scatter_axis(g, 1, h, iy, wy).to(gy.dtype)


def _scales(scale_override):
    return (None, None) if scale_override is None else (float(scale_override[0]), float(scale_override[1]))


def resize_plain(x, size, mode="bilinear", align_corners=False, scale_override=None):
    """Plain PyTorch version of :func:`resize` (any device)."""
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    sh, sw = _scales(scale_override)
    dev = x.device
    iy, wy = _taps_on(h, oh, mode, bool(align_corners), sh, dev)
    ix, wx = _taps_on(w, ow, mode, bool(align_corners), sw, dev)
    y = _apply_axis(wide(x), 1, iy, wy)
    y = _apply_axis(y, 2, ix, wx)
    return y.to(x.dtype)


def resize(x: torch.Tensor, size, mode: str = "bilinear", align_corners: bool = False,
           scale_override=None):
    """Resize NHWC ``x`` (or HWC) to ``size=(H, W)`` as
    ``F.interpolate(x_nchw, size, mode, align_corners)`` does, or, with
    ``scale_override=(sh, sw)``, as ``F.interpolate(x_nchw,
    scale_factor=(sh, sw), mode=mode)`` does when it gives ``size`` (the
    DINOv2 position-embedding interpolation, vit.py:136-145)."""
    if x.ndim == 3:
        return resize(x[None], size, mode, align_corners, scale_override)[0]
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(x.shape)}")
    h, w = x.shape[1:3]
    oh, ow = int(size[0]), int(size[1])
    axis_taps(h, oh, mode, bool(align_corners), _scales(scale_override)[0])  # validates the mode
    if (h, w) == (oh, ow) and mode != "nearest":
        return x
    if wants_grad(x):
        if mode == "nearest":
            raise NotImplementedError("resize has a backward for bilinear and bicubic, not nearest")
        require_float("resize", x)
        return _Resize.apply(x, (oh, ow), mode, bool(align_corners), scale_override)
    return _forward(x, (oh, ow), mode, align_corners, scale_override)


def _forward(x, size, mode, align_corners, scale_override):
    n, h, w, c = x.shape
    oh, ow = size
    sh, sw = _scales(scale_override)
    if _cuda.on_cpu(x):
        return _flops.plain(resize_plain, x, size, mode, align_corners, scale_override)
    _cuda.require_cuda(x)
    th = _packed_taps_on(h, oh, mode, bool(align_corners), sh, x.device)
    tw = _packed_taps_on(w, ow, mode, bool(align_corners), sw, x.device)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    _cuda.check(_launch(x, y, th, tw, None, n, h, w, c, h * w * c, mode == "nearest"), "resize")
    resize.launches += 1
    return y


class _Resize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, mode, align_corners, scale_override):
        ctx.in_shape, ctx.size, ctx.mode, ctx.ac = tuple(x.shape), size, mode, align_corners
        ctx.scale_override = scale_override
        return _forward(x.contiguous(), size, mode, align_corners, scale_override)

    @staticmethod
    def backward(ctx, gy):
        n, h, w, c = ctx.in_shape
        if ctx.mode == "bicubic":
            gx = resize_transpose(gy.contiguous(), (h, w), "bicubic", ctx.ac, ctx.scale_override)
            return gx, None, None, None, None
        g = gy.contiguous().permute(0, 3, 1, 2)  # NCHW view of the NHWC gradient
        gx = torch.ops.aten.upsample_bilinear2d_backward(
            g, list(ctx.size), [n, c, h, w], ctx.ac, *_scales(ctx.scale_override))
        return gx.permute(0, 2, 3, 1), None, None, None, None


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
    forbid_grad("crop_resize", image)
    prh, prw = int(patch_raw_shape[0]), int(patch_raw_shape[1])
    oh, ow = int(out_shape[0]), int(out_shape[1])
    if _cuda.on_cpu(image):
        return _flops.plain(crop_resize_plain, image, starts, (prh, prw), (oh, ow))
    starts = starts.to(device=image.device, dtype=torch.int32).contiguous()
    _cuda.require_cuda(image, starts)
    h, w, c = image.shape
    n = starts.shape[0]
    th = _packed_taps_on(prh, oh, "bilinear", True, None, image.device)
    tw = _packed_taps_on(prw, ow, "bilinear", True, None, image.device)
    y = torch.empty((n, oh, ow, c), dtype=image.dtype, device=image.device)
    _cuda.check(_launch(image, y, th, tw, starts, n, h, w, c, 0), "crop_resize")
    crop_resize.launches += 1
    return y


crop_resize.launches = 0
