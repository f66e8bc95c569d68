"""K1: torchvision-exact ``roi_align(aligned=True)``, NHWC.

Counterpart of ``patchrefinerv2_tpu/ops/roi_align.py`` (``roi_align``
:179, ``roi_align_mxu`` :86, ``roi_align_gather`` :129). Features are
(B, H, W, C), boxes (N, 4) ``[x1, y1, x2, y2]`` with a separate (N,)
``box_idx``. Only ``sampling_ratio=1`` is ported: it is every call site
(the roi never exceeds the feature map and the output size is the feature
size), so other ratios raise.

On a CUDA tensor :func:`roi_align` launches ``csrc/roi_align.cu`` (or
raises), one block per (box, band of output rows) with the path and band
that :func:`launch_plan` picks; on a CPU tensor it runs
:func:`roi_align_plain`.
``roi_align.launches`` counts the kernel launches. A box index outside
the batch raises on the CPU and gives zeros from the kernel.

Under autograd :func:`roi_align` is a ``torch.autograd.Function`` whose
gradient goes to the features only (boxes and indices are data, as in the
JAX package). The op is separable, ``out_n = Wy_n . F[b_n] . Wx_n^T`` with
two taps a row of each axis (``_axis_taps``), so the backward is the
transpose: ``dF[b] += Wy_n^T . dOut_n . Wx_n`` over the boxes ``n`` of
image ``b``, written out as two ``index_add_`` passes over the taps (the W
axis, then the H axis), in PyTorch ops on both devices. A tap outside the
map has weight zero and adds nothing.
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops import _cuda
from patchrefinerv2_torch.ops._grad import require_float, wants_grad, wide

__all__ = ["roi_align", "roi_align_plain", "roi_align_backward", "launch_plan"]

MODES = {"scalar": 0, "channels": 1, "columns": 2}
BAND_BYTES = 32 * 1024  # output bytes a block writes, at least one row


def _axis_taps(lo, hi, out_size: int, in_size: int):
    """Per-box taps along one axis: (i0, i1, w0, w1), each (N, out_size)."""
    i = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one ulp off the quotient the kernel (and the JAX
    # package) computes, which at boxes such as 111.99999 moves the samples
    bins = (hi - lo) / torch.full_like(hi, float(out_size))
    v = lo[:, None] + (i[None, :] + 0.5) * bins[:, None]
    valid = ((v >= -1.0) & (v <= in_size)).float()
    vc = v.clamp(0.0, in_size - 1.0)
    fl = torch.floor(vc)
    fr = vc - fl
    i0 = fl.long()
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    return i0, i1, (1.0 - fr) * valid, fr * valid


def _taps(boxes, spatial_scale, oh, ow, h, w):
    """((yi0, yi1, ay0, ay1), (xi0, xi1, ax0, ax1)): the boxes' taps along H
    and W, float32 weights."""
    bx = boxes.float() * spatial_scale - 0.5
    return (_axis_taps(bx[:, 1], bx[:, 3], oh, h), _axis_taps(bx[:, 0], bx[:, 2], ow, w))


def roi_align_plain(features, boxes, box_idx, output_size, spatial_scale=1.0):
    """Plain PyTorch version of :func:`roi_align` (any device)."""
    b, h, w, c = features.shape
    oh, ow = int(output_size[0]), int(output_size[1])
    (yi0, yi1, ay0, ay1), (xi0, xi1, ax0, ax1) = _taps(boxes, spatial_scale, oh, ow, h, w)
    f = wide(features)[box_idx.long()]  # (N, H, W, C)
    n = f.shape[0]
    rows = torch.arange(n, device=f.device)[:, None]
    # H taps first, then W taps (the reference's contraction order)
    t = f[rows, yi0] * ay0[..., None, None] + f[rows, yi1] * ay1[..., None, None]  # (N, oh, W, C)
    gx0 = xi0[:, None, :, None].expand(n, oh, ow, c)
    gx1 = xi1[:, None, :, None].expand(n, oh, ow, c)
    out = (torch.gather(t, 2, gx0) * ax0[:, None, :, None]
           + torch.gather(t, 2, gx1) * ax1[:, None, :, None])
    return out.to(features.dtype)


def roi_align_backward(gy, feature_shape, boxes, box_idx, spatial_scale):
    """The features' gradient (B, H, W, C) of :func:`roi_align` for the
    output gradient ``gy`` (N, oh, ow, C): each box's output gradient
    spread back over its W taps, then over its H taps into its image."""
    b, h, w, c = feature_shape
    n, oh, ow, _ = gy.shape
    (yi0, yi1, ay0, ay1), (xi0, xi1, ax0, ax1) = _taps(boxes, spatial_scale, oh, ow, h, w)
    gy = wide(gy)
    dt, dev = gy.dtype, gy.device
    # W axis: (N, oh, ow, C) -> (N, oh, W, C), rows (n, i) of W pixels
    row = (torch.arange(n * oh, device=dev) * w).view(n, oh, 1)
    t = torch.zeros((n * oh * w, c), dtype=dt, device=dev)
    for xi, ax in ((xi0, ax0), (xi1, ax1)):
        t.index_add_(0, (row + xi[:, None, :]).reshape(-1),
                     (gy * ax.to(dt)[:, None, :, None]).reshape(-1, c))
    t = t.view(n, oh, w * c)
    # H axis: (N, oh, W, C) -> (B, H, W, C), into each box's image
    base = (box_idx.long() * h).view(n, 1)
    df = torch.zeros((b * h, w * c), dtype=dt, device=dev)
    for yi, ay in ((yi0, ay0), (yi1, ay1)):
        df.index_add_(0, (base + yi).reshape(-1), (t * ay.to(dt)[..., None]).reshape(-1, w * c))
    return df.view(b, h, w, c)


def launch_plan(c: int, oh: int, ow: int, itemsize: int, aligned: bool = True) -> dict:
    """The kernel's path and band for (N, oh, ow, c) outputs of ``itemsize``
    bytes: ``"channels"``, 16-byte vectors of ``vec`` channels of a pixel,
    where c is a multiple of ``vec``; ``"columns"``, ``vec`` consecutive
    outputs of a row, for a 1-channel map whose rows are a multiple of
    ``vec``; else ``"scalar"``, one element a thread. The vector paths need
    the map and the output at 16-byte aligned addresses (``aligned``).
    ``band``: the output rows of a block, ~``BAND_BYTES`` of output."""
    vec = 16 // itemsize
    mode = ("channels" if aligned and c % vec == 0 else
            "columns" if aligned and c == 1 and ow % vec == 0 else "scalar")
    band = max(1, min(oh, BAND_BYTES // max(1, ow * c * itemsize)))
    return dict(mode=mode, vec=1 if mode == "scalar" else vec, band=band, blocks=-(-oh // band))


def roi_align(features, boxes, box_idx, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = 1):
    """Aligned RoI-Align of NHWC ``features`` -> (N, out_h, out_w, C) in the
    features' dtype (float32 or bfloat16; float64 on the CPU)."""
    if sampling_ratio != 1:
        raise NotImplementedError("roi_align is ported for sampling_ratio=1 (every call site)")
    if features.ndim != 4 or boxes.ndim != 2 or boxes.shape[1] != 4 or \
            tuple(box_idx.shape) != (boxes.shape[0],):
        raise ValueError(f"expected NHWC features, (N, 4) boxes and (N,) box indices, got "
                         f"{tuple(features.shape)}, {tuple(boxes.shape)}, {tuple(box_idx.shape)}")
    size = (int(output_size[0]), int(output_size[1]))
    if wants_grad(features):
        require_float("roi_align", features)
        return _RoiAlign.apply(features, boxes.detach(), box_idx, size, float(spatial_scale))
    return _forward(features, boxes, box_idx, size, spatial_scale)


def _forward(features, boxes, box_idx, output_size, spatial_scale):
    if _cuda.on_cpu(features):
        return roi_align_plain(features, boxes, box_idx, output_size, spatial_scale)
    boxes = boxes.to(device=features.device, dtype=torch.float32).contiguous()
    box_idx = box_idx.to(device=features.device, dtype=torch.int32).contiguous()
    _cuda.require_cuda(features, boxes, box_idx)
    dt = _cuda.dtype_code(features.dtype)
    b, h, w, c = features.shape
    n = boxes.shape[0]
    oh, ow = int(output_size[0]), int(output_size[1])
    out = torch.empty((n, oh, ow, c), dtype=features.dtype, device=features.device)
    aligned = features.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = launch_plan(c, oh, ow, features.element_size(), aligned)
    fn = _cuda.bind("roi_align", "prv2_roi_align", 4, 9, 1)
    rc = fn(_cuda.ptr(features), _cuda.ptr(boxes), _cuda.ptr(box_idx), _cuda.ptr(out),
            n, b, h, w, c, oh, ow, plan["band"], MODES[plan["mode"]], float(spatial_scale), dt,
            _cuda.stream_of(features))
    _cuda.check(rc, "roi_align")
    roi_align.launches += 1
    return out


class _RoiAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, boxes, box_idx, size, spatial_scale):
        ctx.save_for_backward(boxes, box_idx)
        ctx.shape, ctx.scale = tuple(features.shape), spatial_scale
        return _forward(features.contiguous(), boxes, box_idx, size, spatial_scale)

    @staticmethod
    def backward(ctx, gy):
        boxes, box_idx = ctx.saved_tensors
        df = roi_align_backward(gy, ctx.shape, boxes, box_idx, ctx.scale)
        return df, None, None, None, None


roi_align.launches = 0
