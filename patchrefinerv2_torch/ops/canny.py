"""K11: canny non-maximum suppression, the counterpart of
``patchrefinerv2_tpu/ops/canny.py`` (``canny_nms`` :14), with a mask mode
that also applies its callers' epilogue, and K12: the bounded hysteresis of
the training losses' canny (``patchrefinerv2_tpu/models/losses_extra.py:129-134``,
``_dilate3x3`` :81).

skimage.feature.canny's bilinear-interpolated NMS over the four gradient
sectors: a pixel is a local maximum when its magnitude is ``>=`` both
neighbours interpolated along its gradient (zero outside the map).
:func:`canny_nms` returns that mask alone. :func:`canny_nms_masks` returns
the low and high masks that both JAX callers take from it
(``models/losses_extra.py:125-128``, ``evaluation/metrics.py:107-110``):
``lm & region & (magnitude > 0)``, at or above each threshold, the region
being the 1-pixel interior or a given mask.

On a CUDA tensor both launch ``csrc/canny.cu`` (float32 or float64) or
raise: one launch a call of a register-strip stencil, a warp walking
:func:`canny_nms_plan`'s rows down a 128-pixel column strip, on 16-byte
vectors where the rows allow them (:func:`nms_vector_path`) and element by
element where they do not. On a CPU tensor they run :func:`canny_nms_plain`
and :func:`canny_nms_masks_plain`, line-by-line transcriptions of the
reference. ``canny_nms.launches`` counts the kernel's launches in either
mode.

:func:`hysteresis_bounded` grows a high mask inside a low mask by ``steps``
3x3 dilations (zero outside the map), each ANDed with the low mask: JAX's
``fori_loop``, which reaches at most ``steps`` pixels along a weak chain. On
a CUDA tensor it launches ``csrc/hysteresis.cu`` (one kernel a call, by the
plan :func:`hysteresis_plan` picks from the plane's size) or raises; on a
CPU tensor it runs :func:`hysteresis_bounded_plain`. It takes bool masks,
which carry no gradient. ``hysteresis_bounded.launches`` counts the calls
that launch the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops import _cuda, _flops

__all__ = ["canny_nms", "canny_nms_plain", "canny_nms_masks", "canny_nms_masks_plain",
           "canny_nms_plan", "nms_vector_path", "nms_launch", "hysteresis_bounded",
           "hysteresis_bounded_plain", "hysteresis_exit_steps_plain", "hysteresis_plan",
           "hysteresis_launch", "hysteresis_latency_floor"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

# csrc/canny.cu: the pixels a thread holds (V), a warp's column strip (32 V
# pixels), the rows R a warp may walk (its template instances) and the warps
# an SM the plan gives the grid at least, where it can
NMS_PIXELS = 4
NMS_STRIP = 32 * NMS_PIXELS
NMS_ROWS = (4, 8)
NMS_WARPS_PER_SM = 8


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


def canny_nms_masks_plain(isobel, jsobel, magnitude, low_threshold: float, high_threshold: float,
                          mask=None):
    """Plain PyTorch version of :func:`canny_nms_masks` (any device): the
    NMS mask, then the callers' epilogue as separate ops."""
    local_maxima = canny_nms_plain(isobel, jsobel, magnitude)
    if mask is None:
        mask = torch.zeros(magnitude.shape, dtype=torch.bool, device=magnitude.device)
        mask[..., 1:-1, 1:-1] = True
    local_maxima = local_maxima & mask & (magnitude > 0)
    return (local_maxima & (magnitude >= float(low_threshold)),
            local_maxima & (magnitude >= float(high_threshold)))


def canny_nms_plan(planes: int, h: int, w: int, sms: int) -> int:
    """The rows R that each warp of K11 walks down its column strip, for
    ``planes`` (h, w) maps on a card of ``sms`` SMs: the most of
    ``NMS_ROWS`` that still gives the grid ``NMS_WARPS_PER_SM`` warps an SM,
    else the fewest."""
    strips = -(-w // NMS_STRIP)
    for rows in reversed(NMS_ROWS):
        if planes * strips * -(-h // rows) >= NMS_WARPS_PER_SM * sms:
            return rows
    return NMS_ROWS[0]


def nms_vector_path(w: int, *tensors) -> bool:
    """Whether K11 runs on its vector path: rows a multiple of ``NMS_PIXELS``
    wide and every map and mask starting on a 16-byte boundary (so that each
    thread's pixels are one aligned vector, all inside the row or all
    outside it); else it reads and writes element by element."""
    return w % NMS_PIXELS == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_maps(what: str, isobel, jsobel, magnitude, mask=None) -> None:
    if magnitude.ndim < 2 or isobel.shape != magnitude.shape or jsobel.shape != magnitude.shape:
        raise ValueError(f"{what}: expected three (..., H, W) maps of one shape, got "
                         f"{tuple(isobel.shape)}, {tuple(jsobel.shape)}, {tuple(magnitude.shape)}")
    if mask is not None:
        if mask.shape != magnitude.shape:
            raise ValueError(f"{what}: expected a mask of the maps' shape {tuple(magnitude.shape)}, "
                             f"got {tuple(mask.shape)}")
        if mask.dtype != torch.bool:
            raise TypeError(f"{what} takes a bool mask, got {mask.dtype}")


def _check_cuda(what: str, isobel, jsobel, magnitude, mask=None) -> None:
    if not (isobel.dtype == jsobel.dtype == magnitude.dtype) or magnitude.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or float64 maps of one dtype, got "
                        f"{isobel.dtype}, {jsobel.dtype}, {magnitude.dtype}")
    _cuda.require_cuda(isobel, jsobel, magnitude, *(() if mask is None else (mask,)))


def nms_launch(isobel, jsobel, magnitude, masks: bool = False, low_threshold: float = 0.0,
               high_threshold: float = 0.0, mask=None, rows: int | None = None,
               vector: bool | None = None):
    """Launch K11 on checked (..., H, W) CUDA maps: the local-maxima mask,
    or with ``masks`` the (low, high) pair over ``mask`` (None: the 1-pixel
    interior). ``rows`` (None: :func:`canny_nms_plan`'s) and ``vector``
    (None: :func:`nms_vector_path`; False forces the scalar path) choose the
    launch."""
    h, w = magnitude.shape[-2:]
    planes = magnitude.numel() // (h * w) if h * w else 0
    if rows is None:
        rows = canny_nms_plan(planes, h, w, _cuda.sms(magnitude.device))
    if rows not in NMS_ROWS:
        raise ValueError(f"rows must be one of {NMS_ROWS}, got {rows}")
    out = torch.empty(magnitude.shape, dtype=torch.bool, device=magnitude.device)
    high = torch.empty_like(out) if masks else None
    io = [t for t in (isobel, jsobel, magnitude, mask, out, high) if t is not None]
    can = nms_vector_path(w, *io)
    if vector is None:
        vector = can
    elif vector and not can:
        raise ValueError("the vector path needs rows a multiple of 4 pixels wide on 16-byte boundaries")
    mode = 0 if not masks else 1 if mask is None else 2
    fn = _cuda.bind("canny", "prv2_canny_nms", 6, 6, 0, 2)
    rc = fn(_cuda.ptr(isobel), _cuda.ptr(jsobel), _cuda.ptr(magnitude), _cuda.ptr(mask),
            _cuda.ptr(out), _cuda.ptr(high), planes, h, w, rows, int(vector), mode,
            float(low_threshold), float(high_threshold), _DTYPE_CODES[magnitude.dtype],
            _cuda.stream_of(magnitude))
    _cuda.check(rc, "canny_nms")
    canny_nms.launches += 1
    return (out, high) if masks else out


def canny_nms(isobel: torch.Tensor, jsobel: torch.Tensor, magnitude: torch.Tensor) -> torch.Tensor:
    """Local-maxima mask (bool, the shape of ``magnitude``) of the (..., H, W)
    gradients ``isobel`` (along H), ``jsobel`` (along W) and their
    ``magnitude``, all float32 or all float64."""
    _check_maps("canny_nms", isobel, jsobel, magnitude)
    if _cuda.on_cpu(magnitude):
        return _flops.plain(canny_nms_plain, isobel, jsobel, magnitude)
    _check_cuda("canny_nms", isobel, jsobel, magnitude)
    return nms_launch(isobel, jsobel, magnitude)


canny_nms.launches = 0


def canny_nms_masks(isobel: torch.Tensor, jsobel: torch.Tensor, magnitude: torch.Tensor,
                    low_threshold: float, high_threshold: float,
                    mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The bool (low, high) masks of the (..., H, W) maps, in one K11 launch:
    ``lm & region & (magnitude > 0) & (magnitude >= threshold)`` for each
    threshold, ``lm`` the local-maxima mask of :func:`canny_nms` and the
    region the 1-pixel interior (``mask`` None) or the bool ``mask`` of the
    maps' shape. The thresholds compare in the maps' dtype, as a Python
    float does against a tensor. Counted on ``canny_nms.launches``."""
    _check_maps("canny_nms_masks", isobel, jsobel, magnitude, mask)
    if _cuda.on_cpu(magnitude):
        return _flops.plain(canny_nms_masks_plain, isobel, jsobel, magnitude, low_threshold,
                            high_threshold, mask)
    _check_cuda("canny_nms_masks", isobel, jsobel, magnitude, mask)
    return nms_launch(isobel, jsobel, magnitude, True, low_threshold, high_threshold, mask)


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


def hysteresis_exit_steps_plain(low: torch.Tensor, high: torch.Tensor, steps: int = 128) -> torch.Tensor:
    """For each (H, W) plane, the index of the first of the ``steps`` steps
    of :func:`hysteresis_bounded_plain` that changes nothing (``steps`` if
    each one does): the step at which the resident kernel leaves its loop.
    int32, the shape of the masks' leading dimensions."""
    h, w = high.shape[-2], high.shape[-1]
    out = high.reshape(-1, h, w)
    lo = low.reshape(-1, h, w)
    exit_at = torch.full((out.shape[0],), steps, dtype=torch.int32, device=high.device)
    for s in range(steps):
        grown = lo & (F.max_pool2d(out[:, None].float(), 3, 1, 1)[:, 0] > 0)
        same = (grown == out).flatten(1).all(1) & (exit_at == steps)
        exit_at[same] = s
        out = grown
        if bool((exit_at < steps).all()):
            break
    return exit_at.reshape(high.shape[:-2])


class HysteresisPlan(NamedTuple):
    """The resident kernel's launch: a cluster of ``cluster`` CTAs a plane,
    each reading and writing a share of its rows, of ``warps`` warps; the
    first CTA runs the steps, each thread holding ``rows`` rows of one
    32-pixel word column. A row's words lie on ``seg`` lanes (a power of
    two), so a warp holds ``32 // seg`` bands of rows."""

    cluster: int
    rows: int
    warps: int
    seg: int


# the rows a thread holds and the CTAs a plane may take: the resident
# kernel's template instances and cluster sizes (csrc/hysteresis.cu,
# prv2_hysteresis_bounded); a CTA has at most MAX_WARPS warps and a row at
# most MAX_WORDS words (1024 pixels)
RESIDENT_ROWS = (2, 4, 6, 8, 12)
RESIDENT_CLUSTERS = (1, 2, 4, 8)
MAX_WARPS = 32
MAX_WORDS = 32
# the CTAs that share a plane's reads and writes: the fastest of 1, 2, 4
# and 8 at the loss's (4, 384, 512) on the H100 (PERF.md, K12)
CLUSTER = 8


def hysteresis_plan(h: int, w: int, cluster: int = CLUSTER) -> HysteresisPlan | None:
    """The resident kernel's plan for an (h, w) plane: ``cluster`` CTAs, the
    fewest rows a thread that one CTA of at most 32 warps holds the plane
    with, and the warps that takes; None when no plan does (wider than 1024
    pixels, or more rows than 32 warps of 12-row strips): such planes take
    the tiled kernel."""
    words = -(-w // 32)
    if h < 1 or w < 1 or words > MAX_WORDS or cluster not in RESIDENT_CLUSTERS:
        return None
    seg = 1 << (words - 1).bit_length()
    bands = 32 // seg  # bands of rows a warp
    for rows in RESIDENT_ROWS:
        warps = -(-h // (bands * rows))
        if warps <= MAX_WARPS:
            return HysteresisPlan(cluster, rows, warps, seg)
    return None


def hysteresis_launch(low: torch.Tensor, high: torch.Tensor, steps: int, plan: HysteresisPlan | None,
                      exit_steps: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K12 on bool (..., H, W) CUDA masks with ``plan`` (None: the
    tiled kernel, every step run) and return the grown mask. ``exit_steps``
    (resident plans only): an int32 CUDA tensor of one entry a plane that
    gets the index of the first step that changed nothing (``steps`` if each
    one did)."""
    _cuda.require_cuda(low, high)
    h, w = low.shape[-2:]
    planes = low.numel() // (h * w) if h * w else 0
    if steps < 1 or planes == 0:
        raise ValueError(f"hysteresis_launch takes steps >= 1 and a nonempty mask, got {steps}, "
                         f"{tuple(low.shape)}")
    out = torch.empty_like(high)
    if plan is None:
        if exit_steps is not None:
            raise ValueError("the tiled kernel runs every step and reports no exit step")
        tmp, geometry = torch.empty_like(high), (0, 0, 0)
    else:
        if exit_steps is not None and (exit_steps.dtype != torch.int32 or exit_steps.numel() != planes
                                       or not exit_steps.is_contiguous()):
            raise ValueError(f"exit_steps must be {planes} contiguous int32 entries")
        tmp, geometry = None, (plan.cluster, plan.rows, plan.warps)
    fn = _cuda.bind("hysteresis", "prv2_hysteresis_bounded", 5, 7)
    rc = fn(_cuda.ptr(low), _cuda.ptr(high), _cuda.ptr(out), _cuda.ptr(tmp), _cuda.ptr(exit_steps),
            planes, h, w, steps, *geometry, 0, _cuda.stream_of(low))
    _cuda.check(rc, "hysteresis_bounded")
    hysteresis_bounded.launches += 1
    return out


def hysteresis_latency_floor(planes: int, steps: int, plan: HysteresisPlan, device) -> None:
    """Launch ``planes`` clusters of ``plan.cluster`` CTAs of ``plan.warps``
    warps running ``steps`` + 1 barrier steps and nothing else: with one
    CTA, the resident kernel's loop without its work (the latency floor of
    a chain of dependent steps); with more, the cluster barrier that steps
    shared by the cluster's CTAs would take. Not a kernel of any path, not
    counted."""
    import ctypes

    fn = _cuda.bind("hysteresis", "prv2_hysteresis_floor", 1, 4)
    rc = fn(_cuda.ptr(None), planes, steps, plan.cluster, plan.warps, 0,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _cuda.check(rc, "hysteresis_latency_floor")


def hysteresis_bounded(low: torch.Tensor, high: torch.Tensor, steps: int = 128) -> torch.Tensor:
    """``out = high``, then ``steps`` times ``out = low & dilate3x3(out)``
    with zeros outside the map, over bool (..., H, W) masks of one shape.
    The resident kernel (planes of :func:`hysteresis_plan`) leaves its loop
    at the first step that changes no pixel of a plane: every later step
    would change nothing either, so the mask is JAX's after all ``steps``
    steps, bit for bit; the tiled kernel runs every step."""
    if low.ndim < 2 or low.shape != high.shape:
        raise ValueError(f"expected two (..., H, W) masks of one shape, got {tuple(low.shape)}, "
                         f"{tuple(high.shape)}")
    if low.dtype != torch.bool or high.dtype != torch.bool:
        raise TypeError(f"hysteresis_bounded takes bool masks, got {low.dtype}, {high.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if _cuda.on_cpu(low):
        return _flops.plain(hysteresis_bounded_plain, low, high, steps)
    _cuda.require_cuda(low, high)
    if steps == 0 or low.numel() == 0:
        return high.clone()
    return hysteresis_launch(low, high, steps, hysteresis_plan(*low.shape[-2:]))


hysteresis_bounded.launches = 0
