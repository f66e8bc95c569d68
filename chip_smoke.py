#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):

1. the device: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build every hand-written kernel from the sources in this checkout (one
   ``nvcc`` per CUDA source, all started together, plus the Triton
   LayerNorm kernel) and print the build seconds;
3. hold every kernel against its plain PyTorch version at the shapes each
   main path gives it: the flagship's and DA2's 2160x3840 frames (``PATHS``)
   in float32 (TF32 off) and bfloat16; the Cityscapes 1024x2048 frame in
   bfloat16; the raw-canvas work of r32 on both frames (``check_rn``: the
   canvases resized to the raw frame, the predictions back to the raw
   patch, the blend of 16 raw patches and finalize at raw size); the
   metrics' float32 prediction resizes to the gt shape; canny_nms at the
   evaluation's (1, 1024, 2048) in float64, where the masks must be equal,
   and float32; K5 ``gate_tail`` at the 10 sites of a 16-patch chunk of
   the flagship and DA2 frames in float32 and bfloat16, gate on, and gate
   off at the head's shape (``check_gate_tail``); K9 ``tail_conv`` at each
   of its 9 sites in the 16- and 8-patch chunks of every path
   (``check_tail_conv``) and its edge cases in
   float32 and bfloat16; K10 ``quant_conv`` at its 15 int8 sites (the 3
   head sites with K9's time beside) in the flagship's 16- and 8-patch
   chunks and DA2's 16-patch chunk in bfloat16 and the flagship's 16-patch
   chunk in float32, with per-channel (by pixel phase at the head unit),
   per-tensor and dynamic scales (``check_quant_conv``), bit for bit, and
   its edge cases; K8 at the flagship's five bins-head calls
   (``BINS_CALLS``: four attractor layers and the log-binomial depth, each
   resizing the centres it takes in) in float32 and bfloat16, with the time
   of the K2 resize each took in before and a bound from its bytes and the
   operations of the function (``bins_operations``); each with
   the tolerance stated, and time the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (device time: ``time_ms``); then, at small shapes,
   the kernels' paths the main paths do not reach (roi_align border bands,
   the other resize modes; every K2 path in float32 and bfloat16: channel
   counts 1, 3, 4, 8, 98, 194, 256 and 322, sources off alignment, a crop
   reaching outside the frame, nearest on maps holding inf and NaN bit for
   bit; padded and per-patch-init blends, bit for bit also on a canvas
   width that is not a multiple of 4, on the add_pass kernel's tile seams
   and with 49 patches over one tile; attention at S = 1, 17, 63, 64,
   65, 769 and 1025, head dims 16, 48 and 64, with and without the bias, in
   float32 and bfloat16 and each shape of the bfloat16 kernel's blocks; the
   gate off, other row counts (one tile of the bfloat16 kernel and one row
   either side) in float32 and bfloat16, normed / exp / sum attractors, canny
   ties, zero gradients and maps one pixel wide or high);
4. build the flagship (``configs/patchrefinerv2_zoedepth/v2_eff_u4k.py``,
   BEiT-L/16 24 blocks + EfficientNet-B5 + BiDirectionalFusion, random
   weights from seed 0) and run a 2160x3840 frame split 4x4 with
   process_num 16: m1 in float32, then m1, m2 and r32 in bfloat16, each a
   first frame and then timed warm frames, and one profiled frame of each
   bfloat16 mode (device time by layer and its 15 costliest kernels,
   device busy share). Then the int8 serving mode: m1 in the dynamic mode
   (first, timed, profiled); calibrate on the frame (the 15 sites must be
   selected), then with per-channel scales m1 and r32 (first, timed,
   profiled) and an m1 first frame with per-tensor scales. The launch
   counters are set to 0 just before each first frame and read just after;
   every kernel but canny_nms (and K10 in the exact runs) must have
   launched, K5 10 times a chunk in every run, K10 15 times a chunk and K9
   6 times in the int8 runs, K10 0 and K9 9 times in the others (7
   roi_align launches a chunk count the chunks), K8 4 + 1 times a frame
   (0 on DA2; ``check_bins_per_frame``). Outputs must be finite
   maps of the reensemble canvas (1536, 2048), or of the raw frame (2160,
   3840) for r32;
5. the Depth-Anything-V2 path (``configs/patchrefinerv2_dav2/plus_eff_u4k.py``:
   DINOv2 ViT-L/14 24 blocks + DPT head at 448x448, the same refiner and
   fusion, random weights from seed 0), m1 in bfloat16 on the same frame:
   a first frame with its own launch-counter check (every kernel but the
   bins head's, canny_nms and K10) and a finite (1792, 1792) map, timed warm
   frames, peak memory and one profiled frame; then calibrated int8 m1 with
   per-channel scales (first, timed, profiled);
6. the Cityscapes evaluation: ``Tester.run`` with
   ``configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_pretrain.py`` in
   bfloat16 over two synthetic 1024x2048 frames (depth, label map, gt
   boundary) in m1, m2 and r32; each mode's counters must show every
   kernel, canny_nms included, and every metric must be finite; the
   inference and metric ms and the prediction's canny edge pixels of each
   frame are printed (random weights give a nearly flat prediction, with
   no edges); then the K2 paths (``ops/resize._launch_plan``) that the runs
   of phases 4-6 took, with their launch counts;
7. the same graphs at a small size on the GPU (kernels) against the CPU
   (plain versions) in float32, with a tiny BEiT and a ``vitt`` DA2 coarse
   branch: m1, m2 and r8 depth must agree, and the flagship's m1 in int8
   (float32, forced), calibrated on the CPU and dynamic, within the
   composed int8 bars;
   and the Cityscapes metrics of one
   full-size frame whose prediction has edges on the card against the CPU,
   then the time of its ``get_metrics`` on the card and of each part.

The line before the last is one JSON object with a record per kernel: its
launches in each main-path run and their sum, and its times, bound and
largest error summed over the shapes of every path in the dtypes the path
runs (``PATH_DTYPES``), with each path's own under ``<path>_<dtype>``
(``flagship_bf16``, ``da2_bf16``, ``r32_bf16``, ``r32_f32``,
``cityscapes_eval_bf16``, ``_f32``, ``_f64``); the last line is
``{"ok": true, "device": {...}}``.
The script imports nothing of JAX. It exits non-zero and prints no result
without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the float32
# rate outside the tensor cores (CUDA-core math, and every float32 kernel
# here) and the dense bfloat16 tensor-core rate (the bfloat16 products of
# the attention, gate_tail and tail_conv kernels)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12  # dense int8 tensor-core rate (K10's products)


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls,
    after a sleep kernel that holds the card while the host enqueues them,
    so that a call whose host side (Python, the launch) takes longer than
    its kernels is not timed by its launch gaps. A call that synchronises
    the host (the plain crop's ``tolist``) is timed with its gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # ~2 GHz cycles for 1.5x the host time of the calls, at most 0.2 s
    torch.cuda._sleep(int(2e9 * min(1.5 * iters * host_s + 1e-4, 0.2)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# The main paths' frames: the flagship's BEiT coarse branch at 384x512 and
# Depth-Anything-V2's DINOv2 at 448x448, each over a 2160x3840 frame, and the
# Cityscapes evaluation's flagship network over a 1024x2048 frame; each split
# 4x4, one chunk of 16 patches. Levels: the six coarse levels and the coarse
# depth that roi_align crops, (h, w, C). ``dtypes``: those the frame's
# kernels are checked in (the evaluation runs bfloat16 only).
FLAGSHIP_LEVELS = [(12, 16, 256), (24, 32, 256), (48, 64, 256), (96, 128, 256), (192, 256, 256),
                   (384, 512, 32), (384, 512, 1)]
PATHS = {
    "flagship": dict(frame=(2160, 3840), process=(384, 512), levels=FLAGSHIP_LEVELS,
                     dtypes=("float32", "bfloat16")),
    "da2": dict(frame=(2160, 3840), process=(448, 448), levels=[
        (16, 16, 256), (32, 32, 256), (64, 64, 256), (128, 128, 256), (256, 256, 256),
        (448, 448, 128), (448, 448, 1)], dtypes=("float32", "bfloat16")),
    "cityscapes_eval": dict(frame=(1024, 2048), process=(384, 512), levels=FLAGSHIP_LEVELS,
                            dtypes=("bfloat16",)),
}


# the dtypes each main path runs its kernels in: the frames in bfloat16 (with
# float32 canvases, which rN resizes and finalizes at raw size); the
# Cityscapes evaluation also resizes its float32 prediction to the gt and
# runs canny in float64 (the JAX host path's dtype). r32 is the flagship's
# r32 frame's raw-canvas work.
PATH_DTYPES = {"flagship": ("bfloat16",), "da2": ("bfloat16",), "r32": ("bfloat16", "float32"),
               "cityscapes_eval": ("bfloat16", "float32", "float64")}
SHORT = {"bfloat16": "bf16", "float32": "f32", "float64": "f64"}


class Checks:
    """Accumulates, per kernel, the shapes checked for each main path in the
    dtypes that path runs, and for all paths together."""

    def __init__(self):
        self.rec = {}

    def add(self, name, path, dtype, err, tol, kernel_ms, plain_ms, library_ms, nbytes, flops,
            peak=F32_FLOPS, main=True, extra=None):
        """Log one check and raise if it fails; record it unless ``main`` is
        false (a dtype that the path does not run at these shapes).
        ``extra``: more times of the check, logged and summed into the
        record under their names."""
        dname = str(dtype).replace("torch.", "")
        ok = err <= tol
        b, by = bound_ms(nbytes, flops, peak)
        extra = extra or {}
        log({"check": name, "path": path, "dtype": dname,
             "max_abs_err": err, "tol": tol, "ok": ok, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": b, "bound_by": by, **extra})
        if not ok:
            raise AssertionError(f"{name} ({path}, {dtype}) disagrees with its plain version: "
                                 f"{err} > {tol}")
        if not main or dname not in PATH_DTYPES[path]:  # keep the path's dtypes only
            return
        for key in (f"{path}_{SHORT[dname]}", "both"):
            r = self.rec.setdefault(name, {}).setdefault(key, dict(
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by={}, extra={}))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += kernel_ms
            r["plain_ms"] += plain_ms
            r["library_ms"] = (None if library_ms is None or r["library_ms"] is None
                               else r["library_ms"] + library_ms)
            r["bound_ms"] += b
            r["by"][by] = r["by"].get(by, 0.0) + b
            for k, v in extra.items():
                r["extra"][k] = r["extra"].get(k, 0.0) + v

    def record(self, name) -> dict:
        """The kernel's numbers summed over the shapes of every path, and each
        path's own under ``<path>_<dtype>``; ``bound_by`` is the limit (bytes
        or operations) behind most of the summed bound."""
        out = {}
        for key, r in self.rec[name].items():
            out[key] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=max(r["by"], key=r["by"].get),
                            library_ms=r["library_ms"], **r["extra"])
        return {**out.pop("both"), **out}


def err_of(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tol_of(ref, dtype) -> float:
    """float32: 1e-5 of the reference's magnitude (both sides compute the
    same float32 arithmetic, in another order); bfloat16: 1e-2 of it (one
    bfloat16 rounding of float32 results that may differ in the last bits)."""
    import torch

    scale = max(float(ref.float().abs().max()), 1.0)
    return (1e-2 if dtype == torch.bfloat16 else 1e-5) * scale


DTYPES = ("float32", "bfloat16")


def roi_grid(boxes, size, spatial_scale, map_hw):
    """The sample grid of roi_align(aligned=True, sampling_ratio=1) for each
    box, as ``F.grid_sample(align_corners=False)`` takes it: (N, out_h, out_w,
    2) of (x, y) normalised to [-1, 1] over a map of ``map_hw``. With
    ``padding_mode="border"`` grid_sample clamps the samples into the map as
    roi_align does; roi_align's zero rule (a sample past -1 or the size)
    never fires at the call sites, whose boxes lie inside the map. K1's
    library yardstick, used nowhere in the port."""
    import torch

    bx = boxes.float() * spatial_scale - 0.5
    oh, ow = size
    h, w = map_hw

    def axis(lo, hi, n):
        i = torch.arange(n, dtype=torch.float32, device=boxes.device)
        return lo[:, None] + (i[None, :] + 0.5) * ((hi - lo) / n)[:, None]

    ys, xs = axis(bx[:, 1], bx[:, 3], oh), axis(bx[:, 0], bx[:, 2], ow)
    gx = ((2 * xs + 1) / w - 1)[:, None, :].expand(-1, oh, -1)
    gy = ((2 * ys + 1) / h - 1)[:, :, None].expand(-1, -1, ow)
    return torch.stack([gx, gy], dim=-1).contiguous()


def check_kernels(chk: Checks, dev) -> None:
    """The PR 1 kernels (K1, K2 bilinear, K6, K7) at the shapes of every
    path's frame, and the rN and metric shapes."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.models.tiling import TileCfg, regular_pass
    from patchrefinerv2_torch.ops.layer_norm import layer_norm, layer_norm_plain
    from patchrefinerv2_torch.ops.resize import crop_resize, crop_resize_plain, resize, resize_plain
    from patchrefinerv2_torch.ops.roi_align import launch_plan as roi_plan
    from patchrefinerv2_torch.ops.roi_align import roi_align, roi_align_plain

    g = torch.Generator(device=dev).manual_seed(1)
    for path, geo in PATHS.items():
        pph, ppw = geo["process"]
        tc = TileCfg(geo["frame"], (4, 4), (pph, ppw))
        prh, prw = tc.patch_raw_shape
        m1 = regular_pass(tc, (0, 0), 16)
        boxes = torch.from_numpy(m1.bboxes).to(dev)
        bidx = torch.zeros(16, dtype=torch.int32, device=dev)
        starts = torch.from_numpy(m1.starts_raw).to(dev)
        for dt in (getattr(torch, d) for d in geo["dtypes"]):
            es = torch.finfo(dt).bits // 8
            # K1: the 7 roi_align calls of one chunk; the yardstick one
            # grid_sample over the boxes' sample grids (roi_grid), in
            # float32 for both dtypes: grid_sample takes its grid in the
            # map's dtype, and a bfloat16 grid moves the samples by up to a
            # pixel at 512-wide maps (the bfloat16 rows' call reads a float32
            # copy of the map, twice its bytes)
            for h, w, c in geo["levels"]:
                f = torch.randn((1, h, w, c), generator=g, device=dev).to(dt)
                args = (f, boxes, bidx, (h, w), h / pph)
                ref = roi_align_plain(*args)
                err = err_of(roi_align(*args), ref)
                fx = f.float().permute(0, 3, 1, 2).expand(16, c, h, w)
                grid = roi_grid(boxes, (h, w), h / pph, (h, w))
                lib_out = F.grid_sample(fx, grid, mode="bilinear", padding_mode="border",
                                        align_corners=False).permute(0, 2, 3, 1)
                lib_err, lib_tol = err_of(lib_out, ref), (1e-2 if dt == torch.bfloat16 else 1e-3) * max(
                    float(ref.float().abs().max()), 1.0)
                log({"check": "roi_align yardstick (grid_sample)", "path": path, "dtype": str(dt)[6:],
                     "level": [h, w, c], "max_abs_err": lib_err, "tol": lib_tol, "ok": lib_err <= lib_tol,
                     "plan": roi_plan(c, h, w, es)})
                if not lib_err <= lib_tol:
                    raise AssertionError(f"grid_sample yardstick of roi_align {(h, w, c)} ({dt}) disagrees: "
                                         f"{lib_err} > {lib_tol}")
                lib = time_ms(lambda: F.grid_sample(fx, grid, mode="bilinear", padding_mode="border",
                                                    align_corners=False))
                chk.add("roi_align", path, dt, err, tol_of(ref, dt), time_ms(lambda: roi_align(*args)),
                        time_ms(lambda: roi_align_plain(*args)), lib,
                        f.numel() * es + 16 * 5 * 4 + ref.numel() * es, 10 * ref.numel())
                del f, ref, lib_out, fx
            # K2: crop-resize of the 16 raw patches -> the process shape
            img = torch.rand((*tc.image_raw_shape, 3), generator=g, device=dev).to(dt)
            crop = (img, starts, (prh, prw), (pph, ppw))
            ref = crop_resize_plain(*crop)
            err = err_of(crop_resize(*crop), ref)
            chk.add("crop_resize", path, dt, err, tol_of(ref, dt), time_ms(lambda: crop_resize(*crop)),
                    time_ms(lambda: crop_resize_plain(*crop)), None,
                    16 * prh * prw * 3 * es + 16 * 2 * 4 + ref.numel() * es, 6 * ref.numel())
            del img, ref
            # K2 bilinear: C2F refinenet1's x2 upsample of 16 patches at 256
            # channels; DA2 also the DPT head's 256x256 -> 448x448 at 128
            ups = [(16, pph // 2, ppw // 2, 256)] + ([(1, 256, 256, 128)] if path == "da2" else [])
            for shape in ups:
                x = torch.randn(shape, generator=g, device=dev).to(dt)
                ref = resize_plain(x, (pph, ppw), "bilinear", True)
                err = err_of(resize(x, (pph, ppw), "bilinear", True), ref)
                lib = time_ms(lambda: F.interpolate(x.permute(0, 3, 1, 2), (pph, ppw), mode="bilinear",
                                                    align_corners=True))
                chk.add("resize", path, dt, err, tol_of(ref, dt),
                        time_ms(lambda: resize(x, (pph, ppw), "bilinear", True)),
                        time_ms(lambda: resize_plain(x, (pph, ppw), "bilinear", True)), lib,
                        x.numel() * es + ref.numel() * es, 6 * ref.numel())
                del x, ref
            # K6: a trunk LayerNorm (769 BEiT or 1025 DINOv2 tokens) and the
            # fusion head's full-resolution 32-channel LN
            tokens = 769 if path == "flagship" else 1025
            for m, c in ((tokens, 1024), (16 * pph * ppw, 32)):
                x = (torch.randn((m, c), generator=g, device=dev) * 2 + 0.5).to(dt)
                wt = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dt)
                b = torch.randn((c,), generator=g, device=dev).to(dt)
                ref = layer_norm_plain(x, wt, b, 1e-6)
                err = err_of(layer_norm(x, wt, b, 1e-6), ref)
                lib = time_ms(lambda: F.layer_norm(x, (c,), wt, b, 1e-6))
                chk.add("layer_norm", path, dt, err, tol_of(ref, dt),
                        time_ms(lambda: layer_norm(x, wt, b)),
                        time_ms(lambda: layer_norm_plain(x, wt, b)), lib,
                        2 * x.numel() * es + 2 * c * es, 8 * x.numel())
                del x, ref
        check_blend(chk, dev, g, path, tc, geo["dtypes"])
    flagship_tc = TileCfg(PATHS["flagship"]["frame"], (4, 4), PATHS["flagship"]["process"])
    cs_tc = TileCfg(PATHS["cityscapes_eval"]["frame"], (4, 4), PATHS["cityscapes_eval"]["process"])
    check_rn(chk, dev, g, "r32", flagship_tc)
    check_rn(chk, dev, g, "cityscapes_eval", cs_tc)
    check_metric_resizes(chk, dev, g, cs_tc)


def check_blend(chk: Checks, dev, g, path, tc, dtypes) -> None:
    """K7 on one chunk of the path's frame: for the flagship and the
    Cityscapes frame an m2 chunk of 8 overlapping patches that straddles the
    init pass and the first shifted pass, blended into canvases as an
    earlier chunk leaves them; for DA2 the m1 init pass of 16 patches. Then
    finalize."""
    import numpy as np
    import torch

    from patchrefinerv2_torch.models.tiling import merge_all_passes, regular_pass
    from patchrefinerv2_torch.ops.blend import TileBlender, add_pass_plain, finalize_plain
    from patchrefinerv2_torch.ops.masks import generate_blend_mask

    pph, ppw = tc.patch_process_shape
    canvas_hw = tc.patch_reensemble_shape
    if path != "da2":
        stream, initv = merge_all_passes(
            [regular_pass(tc, off, 16) for off in ((0, 0), (0, 1), (1, 0), (1, 1))], 8)
        starts_np, initv = stream.starts_process[8:16], initv[8:16]
    else:
        starts_np = regular_pass(tc, (0, 0), 16).starts_process
        initv = np.ones(16, np.float32)
    n = len(starts_np)
    st = torch.from_numpy(starts_np).to(dev)
    iv = torch.from_numpy(initv).to(dev)
    valid = torch.ones(n, device=dev)
    mask = torch.from_numpy(generate_blend_mask((pph, ppw), border=0.15)).to(dev)
    cover = np.zeros(canvas_hw, bool)
    for y, x in starts_np:
        cover[y:y + pph, x:x + ppw] = True
    touched = int(cover.sum())
    ys, xs = np.meshgrid(np.arange(pph), np.arange(ppw), indexing="ij")
    flat = torch.from_numpy(np.concatenate(
        [((ys + y) * canvas_hw[1] + xs + x).ravel() for y, x in starts_np])).to(dev)
    for dt in (getattr(torch, d) for d in dtypes):
        es = torch.finfo(dt).bits // 8
        preds = (torch.rand((n, pph, ppw), generator=g, device=dev) * 10).to(dt)
        # canvases as an earlier chunk leaves them: sum_wp = average * sum_w
        sum_w = torch.rand(canvas_hw, generator=g, device=dev)
        avg = torch.rand(canvas_hw, generator=g, device=dev) * 10
        base = [avg, avg * sum_w, sum_w]
        s_k = TileBlender.init(canvas_hw, dev)
        s_p = TileBlender.init(canvas_hw, dev)
        for a, b, c in zip(s_k, s_p, base):
            a.copy_(c)
            b.copy_(c)
        TileBlender.add_pass(s_k, preds, mask, st, valid=valid, initv=iv)
        add_pass_plain(s_p, preds, mask, st, valid, iv)
        err = max(err_of(a, b) for a, b in zip(s_k, s_p))
        wp = (preds.float() * mask).reshape(-1)
        canvas = base[1].clone().view(-1)
        lib = time_ms(lambda: canvas.index_put_((flat,), wp, accumulate=True))
        chk.add("blend_add_pass", path, dt, err, tol_of(s_p.sum_wp, torch.float32),
                time_ms(lambda: TileBlender.add_pass(s_k, preds, mask, st, valid=valid, initv=iv)),
                time_ms(lambda: add_pass_plain(s_p, preds, mask, st, valid, iv)), lib,
                preds.numel() * es + mask.numel() * 4 + 6 * touched * 4 + n * 16,
                4 * preds.numel())
        ref = finalize_plain(s_p)
        err = err_of(TileBlender.finalize(s_p), ref)
        npx = canvas_hw[0] * canvas_hw[1]
        chk.add("blend_finalize", path, dt, err, tol_of(ref, torch.float32),
                time_ms(lambda: TileBlender.finalize(s_p)), time_ms(lambda: finalize_plain(s_p)),
                None, 4 * npx * 4, 2 * npx)


def check_rn(chk: Checks, dev, g, path, tc) -> None:
    """The raw-canvas work of an r32 frame with process_num 16, at the
    frame's shapes: ``TileBlender.resize`` of the m2 canvases to the raw
    frame (nearest K2 of the average, bilinear align-corners K2 of the
    weights, float32); one random chunk's bfloat16 predictions back to the
    raw patch (nearest K2); their blend at raw size (K7 add_pass of 16
    patches that share one w start, so they overlap heavily, under the raw
    mask + 1e-3, into canvases as ``TileBlender.resize`` leaves them); and
    finalize at raw size."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.models.tiling import random_pass_starts
    from patchrefinerv2_torch.ops.blend import BlendState, TileBlender, add_pass_plain, finalize_plain
    from patchrefinerv2_torch.ops.masks import generate_blend_mask
    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    f32, bf16 = torch.float32, torch.bfloat16
    raw = tc.image_raw_shape
    prh, prw = tc.patch_raw_shape
    pph, ppw = tc.patch_process_shape

    def check_resize(x, size, mode, ac):
        es = x.element_size()
        ref = resize_plain(x, size, mode, ac)
        err = err_of(resize(x, size, mode, ac), ref)
        lib = time_ms(lambda: F.interpolate(x.permute(0, 3, 1, 2), size, mode=mode,
                                            align_corners=ac if mode == "bilinear" else None))
        chk.add("resize", path, x.dtype, err, tol_of(ref, x.dtype),
                time_ms(lambda: resize(x, size, mode, ac)),
                time_ms(lambda: resize_plain(x, size, mode, ac)), lib,
                x.numel() * es + ref.numel() * es, (6 if mode == "bilinear" else 1) * ref.numel())

    canvas = tc.patch_reensemble_shape
    check_resize(torch.rand((1, *canvas, 1), generator=g, device=dev) * 10, raw, "nearest", False)
    check_resize(torch.rand((1, *canvas, 1), generator=g, device=dev) * 3, raw, "bilinear", True)
    check_resize((torch.rand((16, pph, ppw, 1), generator=g, device=dev) * 10).to(bf16),
                 (prh, prw), "nearest", False)

    starts_np = random_pass_starts(torch.Generator().manual_seed(5), tc, 16)
    st = torch.from_numpy(starts_np).to(dev)
    preds = (torch.rand((16, prh, prw), generator=g, device=dev) * 10).to(bf16)
    mask = torch.from_numpy(generate_blend_mask((prh, prw), border=0.15) + 1e-3).to(dev)
    ones, zeros = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    avg = torch.rand(raw, generator=g, device=dev) * 10
    sum_w = torch.rand(raw, generator=g, device=dev) * 3
    base = BlendState(avg, avg * sum_w, sum_w)
    s_k = BlendState(*(t.clone() for t in base))
    s_p = BlendState(*(t.clone() for t in base))
    TileBlender.add_pass(s_k, preds, mask, st)
    add_pass_plain(s_p, preds, mask, st, ones, zeros)
    err = max(err_of(a, b) for a, b in zip(s_k, s_p))
    cover = np.zeros(raw, bool)
    for y, x in starts_np:
        cover[y:y + prh, x:x + prw] = True
    ys, xs = np.meshgrid(np.arange(prh), np.arange(prw), indexing="ij")
    flat = torch.from_numpy(np.concatenate(
        [((ys + y) * raw[1] + xs + x).ravel() for y, x in starts_np])).to(dev)
    wp = (preds.float() * mask).reshape(-1)
    target = base.sum_wp.clone().view(-1)
    lib = time_ms(lambda: target.index_put_((flat,), wp, accumulate=True))
    # no init patch: the weighted sum and the weights are read and written
    chk.add("blend_add_pass", path, bf16, err, tol_of(s_p.sum_wp, f32),
            time_ms(lambda: TileBlender.add_pass(s_k, preds, mask, st)),
            time_ms(lambda: add_pass_plain(s_p, preds, mask, st, ones, zeros)), lib,
            preds.numel() * 2 + mask.numel() * 4 + 4 * int(cover.sum()) * 4 + 16 * 8,
            4 * preds.numel())
    ref = finalize_plain(s_p)
    err = err_of(TileBlender.finalize(s_p), ref)
    npx = raw[0] * raw[1]
    chk.add("blend_finalize", path, f32, err, tol_of(ref, f32),
            time_ms(lambda: TileBlender.finalize(s_p)), time_ms(lambda: finalize_plain(s_p)),
            None, 4 * npx * 4, 2 * npx)


def check_metric_resizes(chk: Checks, dev, g, tc) -> None:
    """K2 in the Cityscapes metrics of an m1 or m2 frame: the float32
    prediction on the reensemble canvas to the gt shape, bilinear with
    align_corners off (the depth metrics) and on (the boundary metrics)."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    x = torch.rand((1, *tc.patch_reensemble_shape, 1), generator=g, device=dev) * 250
    size = tc.image_raw_shape
    for ac in (False, True):
        ref = resize_plain(x, size, "bilinear", ac)
        err = err_of(resize(x, size, "bilinear", ac), ref)
        lib = time_ms(lambda: F.interpolate(x.permute(0, 3, 1, 2), size, mode="bilinear",
                                            align_corners=ac))
        chk.add("resize", "cityscapes_eval", x.dtype, err, tol_of(ref, x.dtype),
                time_ms(lambda: resize(x, size, "bilinear", ac)),
                time_ms(lambda: resize_plain(x, size, "bilinear", ac)), lib,
                4 * (x.numel() + ref.numel()), 6 * ref.numel())


# The flagship's bins head: the four attractor layers (64 bins, 16/8/4/1
# attractors at the decoder levels of a 384x512 input, each resizing the
# previous level's centres) and the log-binomial depth at 384x512 from the
# last level's 192x256 centres: (h, w) -> (H, W), attractors (0: the
# log-binomial)
BINS_CALLS = (((12, 16), (24, 32), 16), ((24, 32), (48, 64), 8), ((48, 64), (96, 128), 4),
              ((96, 128), (192, 256), 1), ((192, 256), (384, 512), 0))


def bins_operations(pixels: int, bins: int, attractors: int, resized: bool) -> int:
    """The operations of one K8 call, counted from the function (an FMA
    counts 2, a division, an exponential and a comparison 1 each), at
    ``pixels`` output pixels of ``bins`` bins: 6 a (pixel, bin) for the
    bilinear resize where the centres are resized (as K2's checks count
    it); for the attractor layer (``attractors`` > 0) 6 a (pixel, bin,
    attractor) (the difference, its square, 300 x square + 1, the quotient
    and the sum) and 2 a (pixel, bin) (the mean's scale and the update);
    for the log-binomial (``attractors`` = 0) 11 a (pixel, bin) (the
    logit's two products and sums, the division by the temperature, the
    max, the difference and its exponential, their sum, the product with
    the centre and its sum) and 18 a pixel (the two ratios of pt, the
    temperature, the clamps, the two logarithms and the last division)."""
    resize = 6 * pixels * bins if resized else 0
    if attractors:
        return resize + pixels * bins * (6 * attractors + 2)
    return resize + pixels * (11 * bins + 18)


def check_new_kernels(chk: Checks, dev) -> None:
    """K3/K4 attention, K8 bins head (``BINS_CALLS``) and bicubic K2 at the
    shapes of the flagship and DA2 frames."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.attention import attention, attention_plain, relative_position_bias
    from patchrefinerv2_torch.ops.bins import (
        attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
    )
    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    g = torch.Generator(device=dev).manual_seed(3)
    # K3: one BEiT-L block at 384x512 (S = 769, grid 24x32, bias from the
    # table); K4: one DINOv2-L block at 448x448 (S = 1025, no bias). q, k, v
    # are the heads of one packed qkv projection, as in the blocks.
    # Tolerance: max error / max |o| < 1e-5 in float32, 1e-2 in bfloat16.
    for dt in (getattr(torch, d) for d in DTYPES):
        es = torch.finfo(dt).bits // 8
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        for path, s, grid in (("flagship", 769, (24, 32)), ("da2", 1025, None)):
            qkv = torch.randn((1, s, 3, 16, 64), generator=g, device=dev).to(dt)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            table = None
            if grid is not None:
                table = torch.randn((47 * 63 + 3, 16), generator=g, device=dev).to(dt)
            args = (q, k, v, 0.125, table, grid)
            ref = attention_plain(*args)
            err = err_of(attention(*args), ref)
            tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(ref.float().abs().max())
            mask = None if grid is None else relative_position_bias(table, grid)[None].to(dt)
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.125))
            chk.add("attention", path, dt, err, tol, time_ms(lambda: attention(*args)),
                    time_ms(lambda: attention_plain(*args)), lib,
                    4 * 16 * s * 64 * es + (0 if table is None else table.numel() * es),
                    4 * 16 * s * s * 64, peak)
    # K8 (flagship only): BINS_CALLS, each with the resize of the centres it
    # takes in. Tolerance in float32: 1e-5 of the magnitude for the
    # attractors, 1e-4 for the log-binomial depth (its softmax divides
    # logits up to ~600 by temperatures down to 0.0212, so a 1-ulp difference
    # in a logarithm moves the depth by ~1e-5 of its range). Beside each: the
    # time of the K2 resize that the call took in before (``absorbed_resize_ms``,
    # the same shapes); the bound is the larger of the bytes (the coarse
    # centres, not the upsampled ones) and the function's operations
    # (``bins_operations``) at the float32 rate outside the tensor cores, in
    # bfloat16 too (the data sheet gives no bfloat16 rate outside them)
    for dt in (getattr(torch, d) for d in DTYPES):
        es = torch.finfo(dt).bits // 8
        for (h, w), (oh, ow), na in BINS_CALLS:
            b = (torch.rand((1, h, w, 64), generator=g, device=dev) * (80 if na == 0 else 2)).to(dt)
            before = time_ms(lambda: resize(b, (oh, ow), "bilinear", True))
            if na:
                a = (torch.rand((1, oh, ow, na), generator=g, device=dev) * 2).to(dt)
                args, name = (a, b, "mean", "inv"), "attractor_update"
                fn, plain = attractor_update, attractor_update_plain
                nbytes = (a.numel() + b.numel() + oh * ow * 64) * es
            else:
                a = (torch.rand((1, oh, ow, 4), generator=g, device=dev) * 3).to(dt)
                args, name = (a, b, 64, 0.0212, 50.0), "log_binomial_depth"
                fn, plain = log_binomial_depth, log_binomial_depth_plain
                nbytes = (a.numel() + b.numel() + oh * ow) * es
            ref, got = plain(*args), fn(*args)
            if na:
                ref, got = ref[0], got[0]
                tol = tol_of(ref, dt)
            else:
                tol = (1e-2 if dt == torch.bfloat16 else 1e-4) * max(float(ref.float().abs().max()), 1.0)
            chk.add(name, "flagship", dt, err_of(got, ref), tol, time_ms(lambda: fn(*args)),
                    time_ms(lambda: plain(*args)), None, nbytes,
                    bins_operations(oh * ow, 64, na, (h, w) != (oh, ow)),
                    extra=dict(absorbed_resize_ms=before))
    # K2 bicubic (DA2 only): the DINOv2-L position embedding, 37x37 -> 32x32
    # x 1024 with the scale factors (32 + 0.1) / 37 (once per coarse forward)
    sc = ((32 + 0.1) / 37, (32 + 0.1) / 37)
    for dt in (getattr(torch, d) for d in DTYPES):
        es = torch.finfo(dt).bits // 8
        x = torch.randn((1, 37, 37, 1024), generator=g, device=dev).to(dt)
        ref = resize_plain(x, (32, 32), "bicubic", False, sc)
        err = err_of(resize(x, (32, 32), "bicubic", False, sc), ref)
        lib = time_ms(lambda: F.interpolate(x.permute(0, 3, 1, 2), scale_factor=sc, mode="bicubic"))
        chk.add("resize", "da2", dt, err, tol_of(ref, dt),
                time_ms(lambda: resize(x, (32, 32), "bicubic", False, sc)),
                time_ms(lambda: resize_plain(x, (32, 32), "bicubic", False, sc)), lib,
                x.numel() * es + ref.numel() * es, 2 * 8 * ref.numel())


# K5's sites in one 16-patch chunk of a path's frame: (name, rows, C, units).
# The C2F decoder's refinenets run at 1/2, 1/4, ... 1/32 of the process
# shape with c2f_features 256, two units each but refinenet5's one; the
# head's unit runs at the process shape with coarse_chl[0] channels (32 in
# the flagship, 128 in DA2): 10 launches a chunk.
def gate_sites(process, h2: int, batch: int = 16) -> list:
    h, w = process
    sites = [(f"refinenet{k}", batch * (h >> k) * (w >> k), 256, 1 if k == 5 else 2) for k in range(1, 6)]
    return sites + [("head", batch * h * w, h2, 1)]


GATE_UNITS_PER_CHUNK = sum(s[3] for s in gate_sites((384, 512), 32))  # 10


def check_gate_tail(chk: Checks, dev) -> None:
    """K5 at every site of a 16-patch chunk of the flagship and DA2 frames
    (``gate_sites``), gate on, in bfloat16 and float32 (TF32 off), and gate
    off at the head's shape (the ``coarse-fusion`` C2F; checked and logged,
    not recorded). A site with two units counts twice in the path's record,
    so that its sums are a chunk's. Tolerance: float32 1e-5 of the output's
    magnitude (the same float32 sums in another order); bfloat16 1e-2 of it
    (one output rounding: the LN output, the 1x1 output and the sigmoid
    are each rounded to bfloat16 on both sides, and a sum in another order
    can cross a rounding boundary). Bound: f and out read once, y written
    once, W and the LayerNorm's parameters; operations 2 P C^2 (bf16 on the
    tensor cores) + 12 P C. No single PyTorch call computes the function.
    Each bfloat16 site logs the kernel's launch plan."""
    import torch

    from patchrefinerv2_torch.ops.gated import gate_tail, gate_tail_plain, launch_plan

    g = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for path in ("flagship", "da2"):
        geo = PATHS[path]
        h2 = geo["levels"][-2][2]
        for dt in (getattr(torch, d) for d in geo["dtypes"]):
            es = torch.finfo(dt).bits // 8
            peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
            sites = gate_sites(geo["process"], h2)
            for name, p, c, units in sites + [("head_gate_off", *sites[-1][1:3], 0)]:
                f = (torch.randn((p, c), generator=g, device=dev) * 2 + 0.3).to(dt)
                out = torch.randn((p, c), generator=g, device=dev).to(dt) if units else None
                w = (torch.randn((c, c, 1, 1), generator=g, device=dev) * c ** -0.5).to(dt)
                lw = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dt)
                lb = (torch.randn((c,), generator=g, device=dev) * 0.1).to(dt)
                args = (f, out, w, lw, lb)
                ref = gate_tail_plain(*args)
                err = err_of(gate_tail(*args), ref)
                ms, plain_ms = time_ms(lambda: gate_tail(*args)), time_ms(lambda: gate_tail_plain(*args))
                n = max(units, 1)
                chk.add("gate_tail", path, dt, err, tol_of(ref, dt), n * ms, n * plain_ms, None,
                        n * ((3 if units else 2) * p * c * es + c * c * es + 2 * c * es),
                        n * (2 * p * c * c + 12 * p * c), peak, main=units > 0)
                plan = launch_plan(p, c, sms) if dt == torch.bfloat16 else None
                log({"gate_tail_site": name, "path": path, "dtype": str(dt)[6:], "rows": p, "channels": c,
                     "units": units, "ms": ms, "plan": plan})
                del f, out, ref, args


# K9's sites in one chunk of a path's frame, in the order the head runs them:
# (name, input part widths, kernel size, Cout, epilogue). ``h2`` is the
# config's head2_features = coarse_chl[0] (32 in the flagship and the
# Cityscapes network, 128 in DA2); fusion1_0 reads (coarse level 0, last_feat)
# and fusion2_0 (its own output, pred1, pred2); f2r_agg_4's second conv reads
# the stage's 98 channels.
def tail_sites(h2: int) -> list:
    return [
        ("output_conv2", (128,), 3, h2, dict(bias=True, act="relu")),
        ("gcu_conv", (h2,), 3, h2, dict(bias=True, residual="x", relu_in=True)),
        ("gcu_fusion_conv", (h2, h2), 3, h2, dict(bias=True)),
        ("out_conv", (h2,), 1, h2, dict(bias=True)),
        ("output_conv3", (h2,), 1, 1, dict(bias=True)),
        ("fusion1_0", (h2, h2), 3, 32, dict(ln=True, act="gelu")),
        ("fusion2_0", (32, 1, 1), 3, 32, dict(ln=True, act="gelu")),
        ("f2r_agg_4_conv2", (98,), 3, 32, dict(act="gelu")),
        ("final_conv", (32,), 3, 1, dict(residual="map", act="relu")),
    ]


def tail_case(g, dev, dt, shape, widths, k, cout, ep):
    """Seeded inputs of one K9 call: (parts, kwargs of ``tail_conv``). The
    depth parts and the update_base are positive maps (depths), the rest
    normal; weights ~ N(0, 1/fan_in)."""
    import torch

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dt)

    parts = [(torch.rand((*shape, c), generator=g, device=dev) * 10).to(dt) if c == 1
             else randn(*shape, c) for c in widths]
    cin = sum(widths)
    kw = dict(weight=randn(cout, cin, k, k, scale=(k * k * cin) ** -0.5), act=ep.get("act", "none"),
              relu_in=ep.get("relu_in", False))
    if ep.get("bias"):
        kw["bias"] = randn(cout, scale=0.1)
    if ep.get("residual") == "x":
        kw["residual"] = parts[0]
    elif ep.get("residual") == "map":
        kw["residual"] = (torch.rand((*shape, cout), generator=g, device=dev) * 10).to(dt)
    if ep.get("ln"):
        kw["ln"] = ((torch.rand((cout,), generator=g, device=dev) + 0.5).to(dt), randn(cout, scale=0.1))
    return parts, kw


def check_tail_conv(chk: Checks, dev) -> None:
    """K9 at every site of the fusion head's full-resolution tail, at the
    shapes of each path's chunks: 16 patches (m1, and r32's random chunks)
    and 8 (m2's chunks) at the process shape, in float32 (TF32 off) and
    bfloat16 as ``PATHS`` lists them. The 16-patch chunk is recorded; the
    8-patch one is checked and logged. Tolerance: float32 1e-5 of the
    output's magnitude (the same float32 sums in another order); bfloat16
    1e-2 of it (both sides round the same float32 result once, and a sum in
    another order can cross a rounding boundary). Bound: each input read
    once (the GatedConvUnit's residual is its input), the weights, the
    output written once; operations 2 * P * k^2 * Cin * Cout, bf16 on the
    tensor cores. The library call is one ``F.conv2d`` (with its bias) on
    the input concatenated beforehand; the ``torch.cat`` is timed beside
    it. Then the edge cases in both dtypes (not timed)."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.tail_conv import launch_plan as tail_plan
    from patchrefinerv2_torch.ops.tail_conv import tail_conv, tail_conv_plain

    g = torch.Generator(device=dev).manual_seed(6)
    for path, geo in PATHS.items():
        h2 = geo["levels"][-2][2]
        for dt in (getattr(torch, d) for d in geo["dtypes"]):
            es = torch.finfo(dt).bits // 8
            peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
            for batch in (16, 8):
                shape = (batch, *geo["process"])
                npx = batch * geo["process"][0] * geo["process"][1]
                for name, widths, k, cout, ep in tail_sites(h2):
                    parts, kw = tail_case(g, dev, dt, shape, widths, k, cout, ep)
                    ref = tail_conv_plain(parts, **kw)
                    err = err_of(tail_conv(parts, **kw), ref)
                    xc = torch.cat(parts, dim=-1).permute(0, 3, 1, 2)
                    wt, b = kw["weight"], kw.get("bias")
                    lib = time_ms(lambda: F.conv2d(xc, wt, b, padding=k // 2))
                    cat_ms = time_ms(lambda: torch.cat(parts, dim=-1))
                    cin = sum(widths)
                    nbytes = (npx * (cin + cout + (cout if ep.get("residual") == "map" else 0))
                              + wt.numel() + 3 * cout) * es
                    chk.add("tail_conv", path, dt, err, tol_of(ref, dt),
                            time_ms(lambda: tail_conv(parts, **kw)),
                            time_ms(lambda: tail_conv_plain(parts, **kw)), lib, nbytes,
                            2 * npx * k * k * cin * cout, peak, main=batch == 16)
                    log({"tail_conv_site": name, "path": path, "dtype": str(dt)[6:], "batch": batch,
                         "in": list(widths), "k": k, "out": cout, "cat_ms": cat_ms,
                         "plan": tail_plan(widths, k, cout, dt)})
                    del parts, kw, ref, xc
    tail_edge_cases(dev, g)


def tail_edge_cases(dev, g) -> None:
    """K9 where the frames do not take it, in float32 and bfloat16 (same
    tolerances): tiles cut by the map's edge (H, W not multiples of the
    16 x 16 tile, or of 8 x 16 at Cout 128; in bfloat16 of the wgmma
    route's 8 x 64 and 4 x 64 tiles), batch 1, Cout 1 and Cout 16 (a
    partial output tile), 1-channel parts, 98 channels, four parts of odd
    widths, a 1x1 conv with LayerNorm, and maps smaller than one tile; then
    each bfloat16 route's ragged edges: the 128-wide ReLU prologue with its
    residual, a 1x1 at N 128, the 98- and 1-channel parts with an image edge
    inside a tile in both directions, Cout 1 with its residual (the mma.sync
    route) and a residual at Cout 20 < N 32 (loaded element by element)."""
    import torch

    from patchrefinerv2_torch.ops.tail_conv import tail_conv, tail_conv_plain

    cases = [((1, 13, 21), (32, 1, 1), 3, 32, dict(ln=True, act="gelu")),
             ((2, 9, 17), (98,), 3, 32, dict(act="gelu")),
             ((1, 5, 7), (32,), 3, 1, dict(residual="map", act="relu")),
             ((1, 10, 33), (32,), 3, 32, dict(bias=True, residual="x", relu_in=True)),
             ((3, 11, 19), (128, 128), 3, 128, dict(bias=True)),
             ((2, 7, 30), (16,), 1, 16, dict(bias=True, ln=True, act="relu")),
             ((2, 6, 9), (8, 8, 3, 5), 3, 20, dict(bias=True, act="gelu")),
             ((1, 3, 2), (128,), 3, 1, dict(bias=True)),
             ((1, 6, 70), (128,), 3, 128, dict(bias=True, residual="x", relu_in=True)),
             ((2, 5, 65), (128,), 1, 128, dict(bias=True)),
             ((1, 17, 66), (98,), 3, 32, dict(act="gelu")),
             ((1, 9, 130), (32, 1, 1), 3, 32, dict(ln=True, act="gelu")),
             ((2, 17, 20), (32,), 3, 1, dict(residual="map", act="relu")),
             ((1, 9, 67), (32,), 3, 20, dict(bias=True, residual="map"))]
    for dt in (torch.float32, torch.bfloat16):
        for shape, widths, k, cout, ep in cases:
            parts, kw = tail_case(g, dev, dt, shape, widths, k, cout, ep)
            ref = tail_conv_plain(parts, **kw)
            err, tol = err_of(tail_conv(parts, **kw), ref), tol_of(ref, dt)
            name = f"tail_conv {shape} in {list(widths)} k{k} out {cout} {sorted(ep)}"
            log({"check": name, "dtype": str(dt)[6:], "max_abs_err": err, "tol": tol, "ok": err <= tol})
            if not err <= tol:
                raise AssertionError(f"{name} ({dt}): kernel and plain version disagree: {err} > {tol}")


# K10's sites in one chunk of a path's frame, the 15 that the reference's
# default gates select (kh * kw * Cout >= 1152, H * W >= 8192, counted on the
# space-to-depth shapes at the head sites; the same on both paths): (site,
# input part widths, Cout, the divisor of the process shape, bias, relu_in +
# residual, how many sites of the chunk have this shape (refinenet1 and 2
# each run it in GateresConfUnit1 and 2), the layout the reference runs it
# in, ReLU after). ``h2``: the head's width, coarse level 0's channels (32 in
# the flagship, 128 in DA2).
def quant_sites(h2: int) -> list:
    return [
        ("refinenet2 GCU conv (+ x)", (256,), 256, 4, True, True, 2, "plain", False),
        ("refinenet2 GCU fusion conv", (256, 256), 256, 4, True, False, 2, "plain", False),
        ("refinenet1 GCU conv (+ x)", (256,), 256, 2, True, True, 2, "plain", False),
        ("refinenet1 GCU fusion conv", (256, 256), 256, 2, True, False, 2, "plain", False),
        ("output_conv1", (256,), 128, 1, True, False, 1, "plain", False),
        ("f2r_agg_2 conv 1", (322,), 322, 4, False, False, 1, "plain", False),
        ("f2r_agg_2 conv 2", (322,), 128, 4, False, False, 1, "plain", False),
        ("f2r_agg_3 conv 1", (194,), 194, 2, False, False, 1, "plain", False),
        ("output_conv2 (qsd_0)", (128,), h2, 1, True, False, 1, "s2d_down", True),
        ("head GCU conv (+ x)", (h2,), h2, 1, True, True, 1, "s2d", False),
        ("head GCU fusion conv", (h2, h2), h2, 1, True, False, 1, "s2d", False),
    ]


QUANT_SCALES = ("perchan", "tensor", "dynamic")


def quant_case(g, dev, dt, shape, widths, cout, k, bias, relu_res, scales, ties=False, zero_ch=False,
               layout="plain", relu_out=False, zero_phase=False):
    """Seeded inputs of one K10 call: (parts, served site, weight, kwargs of
    ``quant_conv``). Channels of uneven ranges; the calibrated abs-max is
    0.9 of the input's own (per channel, by pixel phase at an ``s2d`` site,
    and per tensor), so the clip is reached; ``zero_ch`` calibrates channel
    0 at abs-max 0 (the 1e-8 floor), ``zero_phase`` channel 0 of phase 1;
    ``ties`` draws every input as (an integer + 0.5) / 8 under an abs-max of
    15.875 (the scale 1/8), so that every quantize is an exact tie (half to
    even) and some lie beyond +-127.5. Weights ~ N(0, 1/fan_in) in ``dt``,
    quantized as calibration quantizes them (``scales`` "dynamic": as the
    dynamic mode does, with the live abs-max taken in the call)."""
    import torch

    from patchrefinerv2_torch.models.int8 import Int8Calibration, Served

    cin = sum(widths)
    if ties:
        parts = [((torch.randint(-130, 130, (*shape, c), generator=g, device=dev) + 0.5) / 8).to(dt)
                 for c in widths]
    else:
        parts = [(torch.randn((*shape, c), generator=g, device=dev)
                  * (0.25 + 2 * torch.rand((c,), generator=g, device=dev))).to(dt) for c in widths]
    x = torch.cat(parts, -1).float()
    x = x.clamp(min=0) if relu_res else x.abs()
    if layout == "s2d":
        amax_c = torch.stack([x[:, di::2, dj::2].amax(dim=(0, 1, 2)) for di in range(2) for dj in range(2)])
    else:
        amax_c = x.amax(dim=(0, 1, 2))
    amax_c = amax_c * 0.9 if not ties else torch.full_like(amax_c, 15.875)
    if zero_ch:
        amax_c[..., 0] = 0.0
    if zero_phase:
        amax_c[1, 0] = 0.0
    w = (torch.randn((cout, cin, k, k), generator=g, device=dev) * (k * k * cin) ** -0.5).to(dt)
    site = Served(Int8Calibration.entry(w, amax_c, layout=layout), scales, 0, 0)
    kw = dict(bias=(torch.randn((cout,), generator=g, device=dev) * 0.1).to(dt) if bias else None,
              relu_in=relu_res, residual=parts[0] if relu_res else None, relu_out=relu_out,
              dynamic=site.dynamic)
    return parts, site, w, kw


def k10(parts, site, kw, plain=False):
    """One K10 call (or its plain version) at a served site."""
    from patchrefinerv2_torch.ops.quant import quant_conv, quant_conv_plain

    if plain:
        return quant_conv_plain(parts, site.kq, site.sx, site.scale, **kw)
    return quant_conv(parts, site.kq, site.sx, site.scale, wf=site.wf, **kw)


def check_quant_conv(chk: Checks, dev) -> None:
    """K10 at each of the 15 int8 sites of a chunk, at the shapes of the
    flagship's 16- and 8-patch chunks (m1 and r32's random chunks; m2's) and
    DA2's 16-patch chunk in bfloat16, and the flagship's 16-patch chunk in
    float32, each with per-channel (the serving default, recorded for the
    path in bfloat16; by pixel phase at the two ``s2d`` head sites),
    per-tensor and dynamic scales. Bar: the int32 sums are exact and the
    quantize and epilogue round as the plain version does, so the output
    must equal the plain version's bit for bit. The plain version runs its
    sums as a float64 convolution on the card (timed over one call). Bound:
    int8 operations 2 * P * k^2 * Cin * Cout at 1979 TOP/s against the bytes
    (the input parts, the residual and the output once each, the int8
    weights, one set per phase where phased). The library call is the
    ``F.conv2d`` of the site in the same dtype with its bias, on the input
    concatenated beforehand (the ``torch.cat`` is timed beside it); at the
    three head sites K9 (``tail_conv``, the kernel the exact runs take
    there) is timed on the same inputs and weights in the same dtype. Each
    site's line names the product's tile (rows by pixels; a phased tile's
    pixels span both column phases) and its N split (N, tiles, ring
    stages; ``ops/quant.launch_plan``). Then the edge cases."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.quant import ROWS, RUN, launch_plan
    from patchrefinerv2_torch.ops.tail_conv import tail_conv

    g = torch.Generator(device=dev).manual_seed(7)
    runs = [("flagship", torch.bfloat16, b, sc) for b in (16, 8) for sc in QUANT_SCALES]
    runs += [("da2", torch.bfloat16, 16, sc) for sc in QUANT_SCALES]
    runs += [("flagship", torch.float32, 16, sc) for sc in QUANT_SCALES]
    for path, dt, batch, scales in runs:
        es = torch.finfo(dt).bits // 8
        ph, pw = PATHS[path]["process"]
        for name, widths, cout, div, bias, relu_res, count, layout, relu_out in quant_sites(
                PATHS[path]["levels"][-2][2]):
            shape = (batch, ph // div, pw // div)
            npx = shape[0] * shape[1] * shape[2]
            parts, site, w, kw = quant_case(g, dev, dt, shape, widths, cout, 3, bias, relu_res, scales,
                                            layout=layout, relu_out=relu_out)
            ref = k10(parts, site, kw, plain=True)
            err = err_of(k10(parts, site, kw), ref)
            ms = time_ms(lambda: k10(parts, site, kw))
            plain = time_ms(lambda: k10(parts, site, kw, plain=True), iters=1, warmup=0)
            xc = torch.cat(parts, dim=-1).permute(0, 3, 1, 2)
            wl = w.contiguous(memory_format=torch.channels_last)
            lib = time_ms(lambda: F.conv2d(xc, wl, kw["bias"], padding=1))
            cat_ms = time_ms(lambda: torch.cat(parts, dim=-1)) if len(parts) > 1 else 0.0
            k9_ms = None
            if layout != "plain":
                k9 = dict(bias=kw["bias"], act="relu" if relu_out else "none", relu_in=relu_res,
                          residual=kw["residual"])
                k9_ms = time_ms(lambda: tail_conv(parts, w, **k9))
            cin = sum(widths)
            nphase = site.kq.shape[0] if site.kq.ndim == 5 else 1
            nbytes = (npx * (cin + cout * (2 if relu_res else 1)) * es + nphase * 9 * cin * cout
                      + 4 * (cin + cout))
            for _ in range(count):
                chk.add("quant_conv", path, dt, err, 0.0, ms, plain, lib, nbytes, 2 * npx * 9 * cin * cout,
                        INT8_TENSOR_OPS, main=batch == 16 and scales == "perchan")
            plan = launch_plan(*shape, cin, cout, 3, layout == "s2d", es)
            log({"quant_conv_site": name, "path": path, "dtype": str(dt)[6:], "batch": batch,
                 "scales": scales, "layout": layout, "count": count, "in": list(widths), "out": cout,
                 "hw": [shape[1], shape[2]], "cat_ms": cat_ms, "k9_ms": k9_ms,
                 "tile": [ROWS, RUN * (2 if layout == "s2d" else 1)],
                 "n_split": [[sg["n"], sg["tiles"], sg["stages"]] for sg in plan["segments"]]})
            del parts, site, w, kw, ref, xc, wl
    quant_edge_cases(dev, g)


def quant_edge_cases(dev, g) -> None:
    """K10 where the frames do not take it, float32 and bfloat16, the three
    scale modes (the same bar, bit for bit): Cin 1, 33, 98, 1056 (a 1x1 of
    the encoder at lowered gates), 2 and 4 parts; Cout 1, 8, 20, 322;
    batch 1, maps smaller than one tile, 1 pixel wide or high; a channel
    calibrated at abs-max 0; inputs beyond the calibrated abs-max; exact .5
    ties; ReLU-in with the residual. Phased (``s2d``): batch 1, a 2x2 map,
    an odd 5x7 map, parts 32+32 and 128+128, a phase of a channel at
    abs-max 0, ties; and the ReLU after the rounding. The wgmma kernel's
    tile edges: widths 63, 64, 65, 112 and 224 (runs of 64 pixels), Cout 72
    (an 80-channel tile) and 322 (128 + 128 + 80), Cout 12 and 20 (float32
    rows of 16-byte units that are not 8 outputs), Cin 194 and 322 (padded
    k32 steps), odd phased maps (a zero column in a parity plane), batch
    1."""
    import torch

    cases = [((1, 5, 7), (1,), 1, 3, True, False, {}),
             ((2, 9, 1), (33,), 8, 3, False, False, {}),
             ((1, 1, 13), (98,), 20, 3, True, False, dict(zero_ch=True)),
             ((3, 11, 19), (64, 34), 322, 3, True, False, {}),
             ((1, 10, 33), (24,), 24, 3, True, True, {}),
             ((2, 7, 30), (1056,), 20, 1, False, False, {}),
             ((1, 6, 9), (8, 8, 3, 5), 20, 3, True, False, dict(zero_ch=True)),
             ((2, 8, 16), (40,), 8, 1, True, False, dict(ties=True)),
             ((1, 9, 17), (32, 32), 64, 3, False, False, dict(ties=True)),
             ((1, 2, 2), (32,), 32, 3, True, True, dict(layout="s2d")),
             ((1, 34, 36), (32, 32), 32, 3, True, False, dict(layout="s2d", zero_phase=True)),
             ((2, 5, 7), (32, 32), 32, 3, True, False, dict(layout="s2d")),
             ((1, 18, 40), (128, 128), 128, 3, True, False, dict(layout="s2d", zero_phase=True)),
             ((1, 6, 10), (32, 32), 32, 3, False, False, dict(layout="s2d", ties=True)),
             ((1, 20, 18), (128,), 32, 3, True, False, dict(layout="s2d_down", relu_out=True)),
             ((2, 3, 5), (24,), 24, 3, False, True, dict(relu_out=True)),
             ((1, 5, 63), (194,), 72, 3, True, False, {}),
             ((1, 3, 64), (322,), 322, 3, False, False, {}),
             ((2, 3, 65), (12, 21), 12, 3, True, True, {}),
             ((1, 4, 112), (128, 64), 128, 3, True, True, {}),
             ((1, 2, 224), (256,), 256, 3, True, False, {}),
             ((1, 6, 65), (96,), 20, 1, False, False, {}),
             ((1, 7, 9), (32, 32), 32, 3, True, False, dict(layout="s2d")),
             ((1, 3, 65), (128,), 128, 3, True, True, dict(layout="s2d"))]
    for dt in (torch.float32, torch.bfloat16):
        for scales in QUANT_SCALES:
            for shape, widths, cout, k, bias, relu_res, extra in cases:
                parts, site, _, kw = quant_case(g, dev, dt, shape, widths, cout, k, bias, relu_res,
                                                scales, **extra)
                err = err_of(k10(parts, site, kw), k10(parts, site, kw, plain=True))
                name = f"quant_conv {shape} in {list(widths)} k{k} out {cout} {scales} {sorted(extra.items())}"
                log({"check": name, "dtype": str(dt)[6:], "max_abs_err": err, "tol": 0.0, "ok": err == 0})
                if err != 0:
                    raise AssertionError(f"{name} ({dt}): kernel and plain version disagree: {err}")


def check_canny(chk: Checks, dev) -> None:
    """K11 at the evaluation's shape, one (1, 1024, 2048) Cityscapes frame:
    the Sobel gradients of a seeded random smooth map, in float64 (the
    evaluation's dtype: the masks must equal the plain version's) and in
    float32 (at most 1e-4 of the pixels may differ; logged, not recorded
    for the path). The error is the share of pixels whose mask differs."""
    import torch

    from patchrefinerv2_torch.evaluation.metrics import _gaussian_filter, _sobel
    from patchrefinerv2_torch.ops.canny import canny_nms, canny_nms_plain

    g = torch.Generator(device=dev).manual_seed(4)
    x = _gaussian_filter(torch.randn((1024, 2048), generator=g, device=dev, dtype=torch.float64), 2.0)
    gi, gj = _sobel(x, 0).contiguous(), _sobel(x, 1).contiguous()
    maps64 = [t[None] for t in (gi, gj, torch.hypot(gi, gj))]
    for dt, tol in ((torch.float64, 0.0), (torch.float32, 1e-4)):
        maps = [t.to(dt).contiguous() for t in maps64]
        got, ref = canny_nms(*maps), canny_nms_plain(*maps)
        err = float((got != ref).double().mean())
        n = ref.numel()
        chk.add("canny_nms", "cityscapes_eval", dt, err, tol, time_ms(lambda: canny_nms(*maps)),
                time_ms(lambda: canny_nms_plain(*maps)), None,
                3 * n * torch.finfo(dt).bits // 8 + n, 20 * n, main=dt == torch.float64)
        log({"check": "canny_nms local maxima", "dtype": str(dt), "count": int(ref.sum()), "of": n})


def check_edge_cases(dev) -> None:
    """Paths of the kernels that the flagship frame does not reach, each held
    against its plain version in float32 (K2 and attention in bfloat16 too;
    not timed): roi_align samples in every border band of the map, resize
    with align_corners off and nearest (up and down), blending with an init
    pass, per-patch init flags and a padded patch; the zeros the kernels
    write for indices outside the maps; then the K2 paths, attention's
    shapes and nearest on non-finite maps (``resize_edge_cases``,
    ``new_kernel_edge_cases``, ``nearest_nonfinite_bit_equal``)."""
    import torch

    from patchrefinerv2_torch.ops.blend import TileBlender, add_pass_plain, finalize_plain
    from patchrefinerv2_torch.ops.resize import crop_resize, resize, resize_plain
    from patchrefinerv2_torch.ops.roi_align import roi_align, roi_align_plain

    g = torch.Generator(device=dev).manual_seed(2)
    f = torch.randn((2, 8, 8, 3), generator=g, device=dev)
    boxes = torch.tensor([[-0.75, -0.75, 1.25, 1.25], [7.5, 7.5, 9.5, 9.5], [-0.75, 7.5, 1.25, 9.5],
                          [7.5, -0.75, 9.5, 1.25], [8.375, 8.375, 10.375, 10.375],
                          [-3.0, -2.0, 11.0, 12.0]], device=dev)
    idx = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32, device=dev)
    cases = [("roi_align border bands", roi_align(f, boxes, idx, (8, 8), 1.0),
              roi_align_plain(f, boxes, idx, (8, 8), 1.0))]
    x = torch.randn((2, 13, 17, 5), generator=g, device=dev)
    for mode, ac, size in (("bilinear", False, (29, 40)), ("bilinear", False, (6, 7)),
                           ("nearest", False, (29, 40)), ("nearest", False, (6, 7)),
                           ("bilinear", True, (6, 7))):
        cases.append((f"resize {mode} align_corners={ac} to {size}", resize(x, size, mode, ac),
                      resize_plain(x, size, mode, ac)))
    preds = torch.rand((3, 6, 8), generator=g, device=dev) * 10
    mask = torch.rand((6, 8), generator=g, device=dev)
    st = torch.tensor([[0, 0], [3, 4], [6, 8]], dtype=torch.int32, device=dev)
    ones = torch.ones(3, device=dev)
    valid = torch.tensor([1.0, 1.0, 0.0], device=dev)
    initv = torch.tensor([0.0, 1.0, 1.0], device=dev)
    s_k, s_p = TileBlender.init((12, 16), dev), TileBlender.init((12, 16), dev)
    TileBlender.add_pass(s_k, preds, mask, st, init_pass=True)
    add_pass_plain(s_p, preds, mask, st, ones, ones)
    TileBlender.add_pass(s_k, preds.flip(0), mask, st, valid=valid, initv=initv)
    add_pass_plain(s_p, preds.flip(0), mask, st, valid, initv)
    cases += [(f"blend {name}", a, b) for name, a, b in zip(s_k._fields, s_k, s_p)]
    cases.append(("blend finalize", TileBlender.finalize(s_k), finalize_plain(s_p)))
    cases += blend_edge_cases(dev, g)
    # indices outside the maps: the kernels write zeros (the plain versions raise)
    far = torch.tensor([[9, 9]], dtype=torch.int32, device=dev)
    outside = [roi_align(f, boxes[:1], torch.tensor([2], dtype=torch.int32, device=dev), (8, 8)),
               crop_resize(f[0].contiguous(), far, (4, 4), (4, 4))]
    cases += [(f"{name} out of range gives zeros", got, torch.zeros_like(got))
              for name, got in zip(("roi_align", "crop_resize"), outside)]
    cases += new_kernel_edge_cases(dev, g) + resize_edge_cases(dev, g)
    for name, got, ref in cases:
        err, tol = err_of(got, ref), tol_of(ref, got.dtype)
        log({"check": name, "dtype": str(got.dtype)[6:], "max_abs_err": err, "tol": tol, "ok": err <= tol})
        if not err <= tol:
            raise AssertionError(f"{name}: kernel and plain version disagree: {err} > {tol}")
    nearest_nonfinite_bit_equal(dev, g)


def blend_edge_cases(dev, g) -> list:
    """(name, kernel canvas, plain canvas) for the add_pass kernel's paths
    that the frames do not reach, each bit for bit (tolerance 0): a canvas
    width that is not a multiple of 4 (scalar canvas accesses), patches
    that start or end on a seam of the kernel's canvas tiles or reach the
    canvas edge, and 49 patches overlapping one tile (m2 with
    process_num 49: a tile's list taken in two pieces), float32 and
    bfloat16 predictions, per-patch init and valid flags."""
    import torch

    from patchrefinerv2_torch.ops.blend import TILE, BlendState, TileBlender, add_pass_plain

    th, tw = TILE
    cases = []
    for name, canvas, hw, starts in (
            ("odd width", (37, 301), (7, 29), [[i % 30, (7 * i) % 272] for i in range(20)]),
            ("tile seams and edge", (2 * th + 5, 3 * tw), (9, 17),
             [[th - 9, tw - 17], [th, tw], [th - 4, 2 * tw - 8], [2 * th + 5 - 9, 3 * tw - 17], [0, 0]]),
            ("49 over one tile", (th + 8, tw + 40), (th, tw), [[i % 9, (3 * i) % 41] for i in range(49)])):
        n = len(starts)
        for dt in (torch.float32, torch.bfloat16):
            preds = (torch.rand((n, *hw), generator=g, device=dev) * 10).to(dt)
            mask = torch.rand(hw, generator=g, device=dev) + 1e-3
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            valid = (torch.rand((n,), generator=g, device=dev) > 0.1).float()
            initv = (torch.rand((n,), generator=g, device=dev) > 0.5).float()
            base = [torch.rand(canvas, generator=g, device=dev) * 10 for _ in range(3)]
            s_k = BlendState(*(t.clone() for t in base))
            s_p = BlendState(*(t.clone() for t in base))
            TileBlender.add_pass(s_k, preds, mask, st, valid=valid, initv=initv)
            add_pass_plain(s_p, preds, mask, st, valid, initv)
            for field, a, b in zip(s_k._fields, s_k, s_p):
                label = f"blend {name} {str(dt)[6:]} {field}"
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: differs from the plain version")
                cases.append((label, a, b))
    return cases


def resize_edge_cases(dev, g) -> list:
    """(name, kernel output, plain output) for each path of the K2 kernel
    (``ops/resize._launch_plan``), float32 and bfloat16, at small shapes:
    channel counts 1 and 3 (the run path), 4, 98, 194 and 322 (4- and
    8-byte channel vectors), 8 and 256 (16-byte ones), each in every mode
    up and down; sources offset by 1 and 2 elements from an aligned buffer
    (the run path, or narrower vectors); a crop reaching outside the frame,
    whose outputs with a tap outside it are zeros."""
    import numpy as np
    import torch

    from patchrefinerv2_torch.ops.resize import axis_taps, crop_resize, crop_resize_plain, resize, resize_plain

    cases = []
    modes = (("bilinear", True, (29, 40)), ("bilinear", False, (6, 7)), ("nearest", False, (29, 40)),
             ("nearest", False, (6, 7)), ("bicubic", False, (20, 11)))
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for c in (1, 3, 4, 8, 98, 194, 256, 322):
            x = torch.randn((2, 13, 17, c), generator=g, device=dev).to(dt)
            for mode, ac, size in modes:
                cases.append((f"resize {name} C={c} {mode} align_corners={ac} to {size}",
                              resize(x, size, mode, ac), resize_plain(x, size, mode, ac)))
        for off in (1, 2):
            buf = torch.randn((off + 2 * 13 * 17 * 8,), generator=g, device=dev).to(dt)
            x = buf[off:].view(2, 13, 17, 8)
            for mode, ac, size in modes[:3]:
                cases.append((f"resize {name} C=8 offset {off} {mode} to {size}",
                              resize(x, size, mode, ac), resize_plain(x, size, mode, ac)))
        img = torch.rand((20, 24, 3), generator=g, device=dev).to(dt)
        starts = torch.tensor([[14, 18], [3, 20], [0, 0], [12, 4]], dtype=torch.int32, device=dev)
        pad = 8
        padded = torch.nn.functional.pad(img.permute(2, 0, 1), (pad, pad, pad, pad)).permute(1, 2, 0)
        ref = crop_resize_plain(padded.contiguous(), starts + pad, (8, 8), (5, 7))
        iy, ix = axis_taps(8, 5, "bilinear", True)[0], axis_taps(8, 7, "bilinear", True)[0]
        st = starts.cpu().numpy()
        inside = ((st[:, :1, None] + iy[1][None, :, None] < 20) &
                  (st[:, 1:, None] + ix[1][None, None, :] < 24))
        ref = ref * torch.from_numpy(inside[..., None]).to(dev, dt)
        cases.append((f"crop_resize {name} reaching outside the frame",
                      crop_resize(img, starts, (8, 8), (5, 7)), ref))
    return cases


def nearest_nonfinite_bit_equal(dev, g) -> None:
    """Nearest K2 of maps holding inf, -inf and NaN (1 channel: the run path;
    8: the channel path), float32 and bfloat16, up and down: the kernel's
    output must equal the plain version's bit for bit, NaN where it has NaN
    (w0 * v + w1 * v with w1 = 0 turns an inf into NaN in both)."""
    import torch

    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    for dt in (torch.float32, torch.bfloat16):
        for c in (1, 8):
            x = torch.randn((2, 13, 17, c), generator=g, device=dev)
            pick = torch.rand(x.shape, generator=g, device=dev)
            x[pick < 0.05] = float("inf")
            x[(pick >= 0.05) & (pick < 0.1)] = -float("inf")
            x[(pick >= 0.1) & (pick < 0.15)] = float("nan")
            x = x.to(dt)
            for size in ((29, 40), (6, 7)):
                got, ref = resize(x, size, "nearest"), resize_plain(x, size, "nearest")
                nan_got, nan_ref = torch.isnan(got), torch.isnan(ref)
                ok = bool(torch.equal(nan_got, nan_ref)) and bool(torch.equal(got[~nan_got], ref[~nan_ref]))
                name = f"resize nearest non-finite {str(dt)[6:]} C={c} to {size}"
                log({"check": name, "nan": int(nan_ref.sum()), "bit_equal": ok, "ok": ok})
                if not ok:
                    raise AssertionError(f"{name}: kernel and plain version differ")


def new_kernel_edge_cases(dev, g) -> list:
    """(name, kernel output, plain output) in float32 for the paths of the
    attention, gate_tail, bins and bicubic kernels that the frames do not
    reach: ragged token counts (S not a multiple of the 32-query or 64-key
    tiles), head dims 16 and 48 (the small composed graphs'), non-square
    grids, two batches; the gate off and ragged row counts (gate_tail in
    bfloat16 too); K8 in bfloat16 too, at odd and identity resizes, two
    images, 12 and 16 bins, 1 and 16 attractors, every kind, type and normed
    case, and 12, 16 and 1024 bins of the log-binomial; bicubic upsampling."""
    import torch

    from patchrefinerv2_torch.ops.attention import attention, attention_plain
    from patchrefinerv2_torch.ops.bins import (
        attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
    )
    from patchrefinerv2_torch.ops.gated import gate_tail, gate_tail_plain
    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    import itertools

    cases = []
    for b, h, s, d, grid in ((2, 3, 37, 16, (4, 9)), (1, 2, 50, 48, None), (1, 4, 65, 64, (8, 8)),
                             (2, 2, 1, 64, None)):
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev) for _ in range(3))
        table = None
        if grid is not None:
            table = torch.randn(((2 * grid[0] - 1) * (2 * grid[1] - 1) + 3, h), generator=g,
                                device=dev)
        cases.append((f"attention S={s} D={d} bias={grid is not None}",
                      attention(q, k, v, d ** -0.5, table, grid),
                      attention_plain(q, k, v, d ** -0.5, table, grid)))
    # every S on both sides of the 64-row and 64-key tiles and the two frame
    # lengths, each head dim, with the bias (a grid of S - 1 patches; S = 1
    # has none) and without, float32 and bfloat16; q, k, v the heads of one
    # packed qkv as in the blocks. In bfloat16 the (batch, heads) pick the
    # blocks' shape: 1 x 2 two key groups of 4 row-warps; at S = 1025, 1 x 16
    # (DINOv2-L) two groups of 5, 2 x 16 one group of 4
    grids = {17: (4, 4), 63: (2, 31), 64: (7, 9), 65: (8, 8), 769: (24, 32), 1025: (32, 32)}
    for dt in (torch.float32, torch.bfloat16):
        for s in (1, 17, 63, 64, 65, 769, 1025):
            for d, (b, h) in itertools.product((16, 48, 64),
                                               ((1, 2), (1, 16), (2, 16)) if s == 1025 else ((1, 2),)):
                for grid in ((None, grids[s]) if s in grids else (None,)):
                    qkv = torch.randn((b, s, 3, h, d), generator=g, device=dev).to(dt)
                    q, k, v = qkv.permute(2, 0, 3, 1, 4)
                    table = None
                    if grid is not None:
                        table = torch.randn(((2 * grid[0] - 1) * (2 * grid[1] - 1) + 3, h),
                                            generator=g, device=dev).to(dt)
                    cases.append((f"attention {str(dt)[6:]} S={s} D={d} B={b} H={h} bias={grid is not None}",
                                  attention(q, k, v, d ** -0.5, table, grid),
                                  attention_plain(q, k, v, d ** -0.5, table, grid)))
    # gate_tail: ragged row counts, one tile of the bfloat16 kernel and one
    # row either side (256 rows at C = 32, 64 above), a single row
    for dt in (torch.float32, torch.bfloat16):
        for p, c, gate in ((1000, 128, True), (777, 32, True), (1000, 32, False), (333, 256, False),
                           (1, 256, True), (255, 32, True), (256, 32, False), (257, 32, True),
                           (63, 128, False), (64, 128, True), (65, 128, True), (63, 256, True),
                           (64, 256, False), (65, 256, True)):
            f = (torch.randn((p, c), generator=g, device=dev) * 2 + 0.3).to(dt)
            out = torch.randn((p, c), generator=g, device=dev).to(dt) if gate else None
            w = (torch.randn((c, c, 1, 1), generator=g, device=dev) * c ** -0.5).to(dt)
            lw = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dt)
            lb = (torch.randn((c,), generator=g, device=dev) * 0.1).to(dt)
            cases.append((f"gate_tail {str(dt)[6:]} P={p} C={c} gate={gate}", gate_tail(f, out, w, lw, lb),
                          gate_tail_plain(f, out, w, lw, lb)))
    # K8 in float32 and bfloat16: the centres resized at an odd ratio, at the
    # identity, 2 images; 12 and 16 bins (a pixel's lanes not a warp), 1 and 16
    # attractors, 16-byte bin vectors (the last shape); every kind, type and
    # normed case
    for dt in (torch.float32, torch.bfloat16):
        for bsz, src, out, na, nb in ((2, (7, 9), (13, 17), 16, 64), (1, (13, 17), (13, 17), 1, 16),
                                      (2, (5, 6), (9, 11), 1, 12), (1, (6, 5), (12, 10), 3, 16),
                                      (1, (48, 64), (96, 128), 3, 64)):
            a = (torch.rand((bsz, *out, na), generator=g, device=dev) * 2).to(dt)
            bc = torch.rand((bsz, *src, nb), generator=g, device=dev).to(dt)
            for kind, typ, normed in itertools.product(("mean", "sum"), ("inv", "exp"), (False, True)):
                got = attractor_update(a, bc, kind, typ, normed, 1e-3, 80.0)
                ref = attractor_update_plain(a, bc, kind, typ, normed, 1e-3, 80.0)
                name = f"attractor {str(dt)[6:]} {bsz}x{src}->{out} na={na} nb={nb} {kind} {typ} normed={normed}"
                cases += [(f"{name} b_new", got[0], ref[0]), (f"{name} centers", got[1], ref[1])]
        for bsz, src, out, k in ((3, (5, 7), (5, 7), 16), (2, (7, 9), (13, 17), 64), (1, (4, 5), (9, 11), 12),
                                 (1, (13, 17), (13, 17), 64), (1, (3, 4), (5, 7), 1024)):
            pt = (torch.rand((bsz, *out, 4), generator=g, device=dev) * 3).to(dt)
            cen = torch.sort(torch.rand((bsz, *src, k), generator=g, device=dev) * 10, dim=-1).values.to(dt)
            cases.append((f"log_binomial_depth {str(dt)[6:]} {bsz}x{src}->{out} K={k}",
                          log_binomial_depth(pt, cen, k, 5.0, 50.0), log_binomial_depth_plain(pt, cen, k, 5.0, 50.0)))
    x = torch.randn((2, 13, 17, 5), generator=g, device=dev)
    cases.append(("resize bicubic up", resize(x, (29, 40), "bicubic"),
                  resize_plain(x, (29, 40), "bicubic")))
    return cases + canny_edge_cases(dev, g)


def canny_edge_cases(dev, g) -> list:
    """(name, kernel mask, plain mask) as float: exact ties (small integer
    gradients, a flat magnitude, pure axis and diagonal directions), all-zero
    gradients, maps 1 pixel wide or high and several maps in a batch, in
    float64 and float32."""
    import torch

    from patchrefinerv2_torch.ops.canny import canny_nms, canny_nms_plain

    def ints(shape):
        return torch.randint(-2, 3, shape, generator=g, device=dev).double()

    gi, gj = ints((3, 37, 70)), ints((3, 37, 70))
    flat_i = torch.randn((40, 50), generator=g, device=dev, dtype=torch.float64)
    maps = {
        "integer ties, batch 3": (gi, gj, torch.hypot(gi, gj)),
        "flat magnitude, axis and diagonal": (flat_i, torch.cat([flat_i[:20], torch.zeros_like(flat_i[20:])]),
                                              torch.full((40, 50), 1.5, device=dev, dtype=torch.float64)),
        "all-zero gradients": tuple(torch.zeros((9, 33), device=dev, dtype=torch.float64) for _ in range(3)),
        "1 pixel wide": (gi[:, :, :1], gj[:, :, :1], torch.hypot(gi, gj)[:, :, :1]),
        "1 pixel high": (gi[0, :1], gj[0, :1], torch.hypot(gi, gj)[0, :1]),
    }
    cases = []
    for name, m in maps.items():
        for dt in (torch.float64, torch.float32):
            m_dt = [t.to(dt).contiguous() for t in m]
            cases.append((f"canny_nms {name} {str(dt)[6:]}", canny_nms(*m_dt).float(),
                          canny_nms_plain(*m_dt).float()))
    return cases


# kernel-name fragments -> the layer they belong to (first match wins)
KERNEL_GROUPS = (
    ("K3/K4 attention", ("attention_kernel", "attention_mma_kernel")),
    ("K5 gate_tail", ("gate_tail",)),
    ("K9 tail_conv", ("tail_conv_kernel", "tail_wgmma_kernel")),
    ("K10 quant_conv", ("qconv_wgmma_kernel", "quantize_kernel", "absmax_kernel", "scales_kernel")),
    ("K8 bins", ("attractor_kernel", "log_binomial_kernel")),
    ("K1 roi_align", ("roi_align_kernel",)),
    ("K2 resize", ("resize_row_kernel",)),
    ("K6 layer_norm", ("ln_rows",)),
    ("K7 blend", ("blend_add_kernel", "blend_finalize_kernel")),
    ("K11 canny", ("canny_nms_kernel",)),
    ("cudnn layout padding", ("nhwcaddpadding", "nchwtonhwc", "nhwctonchw")),
    ("gather and index", ("gather", "index", "scatter")),
    ("batch norm", ("batch_norm",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "winograd", "depthwise")),
    ("matmul", ("gemm", "cublas", "cutlass", "xmma", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy and cat", ("copy", "cat", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
)


# each K group's wrappers (names of ``ops.KERNELS``), and whether the
# profile must count exactly one kernel of the group a call: K1, K5 and K9,
# one launch a call, in the chunk part of the frame. The profiler can drop
# the first events of a frame (DA2's coarse branch lost 2 of 24 attention
# launches in one run), so the other groups must only have launches where
# their wrappers counted some: a kernel renamed out of its group's
# fragments leaves the group empty
K_GROUP_WRAPPERS = {
    "K1 roi_align": (("roi_align",), True),
    "K2 resize": (("resize", "crop_resize"), False),
    "K3/K4 attention": (("attention",), False),
    "K5 gate_tail": (("gate_tail",), True),
    "K6 layer_norm": (("layer_norm",), False),
    "K7 blend": (("blend_add_pass", "blend_finalize"), False),
    "K8 bins": (("attractor_update", "log_binomial_depth"), False),
    "K9 tail_conv": (("tail_conv",), True),
    "K10 quant_conv": (("quant_conv",), False),
    "K11 canny": (("canny_nms",), False),
}


def profile_frame(fn, frame_ms: float, label: str) -> None:
    """One frame under torch.profiler: device time by layer, the costliest
    kernels, and the share of the unprofiled frame time the device spends
    in kernels. Every kernel of ``csrc/`` and of the Triton ops must fall in
    its own K group: each group's profiled launches are held against its
    wrappers' launch counters over the frame (``K_GROUP_WRAPPERS``), so a
    kernel whose name no longer matches its group's fragments fails the run
    instead of landing in another group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from patchrefinerv2_torch import ops

    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    groups, launches, total, kernels = {}, {}, 0.0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
        launches[group] = launches.get(group, 0) + e.count
        total += us
        kernels.append((us / 1e3, e.count, e.key[:90]))
    want = {grp: sum(counts[w] for w in wrappers) for grp, (wrappers, _) in K_GROUP_WRAPPERS.items()}
    log({"phase": f"profile_{label}", "device_ms": total / 1e3, "frame_ms": frame_ms,
         "device_busy_share": total / 1e3 / frame_ms,
         "by_layer_ms": {g: v / 1e3 for g, v in sorted(groups.items(), key=lambda kv: -kv[1])},
         "k_group_launches_profiled_vs_counted": {g: [launches.get(g, 0), n] for g, n in want.items()},
         "top_kernels_ms_calls_name": sorted(kernels, reverse=True)[:15]})
    for grp, (_, exact) in K_GROUP_WRAPPERS.items():
        got = launches.get(grp, 0)
        if (exact and got != want[grp]) or (want[grp] > 0 and got == 0):
            raise AssertionError(f"{label}: the profile puts {got} kernel launches in {grp!r}, its wrappers "
                                 f"counted {want[grp]}: a kernel of the group is named outside its fragments")


# kernels that the frames do not run: canny belongs to the evaluation, K10
# to the int8 serving mode
FRAME_IDLE_OK = ("canny_nms", "quant_conv")
INT8_IDLE_OK = ("canny_nms",)
QUANT_SITES_PER_CHUNK = sum(s[6] for s in quant_sites(32))  # 15
# the head's int8 sites, which K10 takes from K9 in the int8 runs
HEAD_INT8_SITES = sum(s[6] for s in quant_sites(32) if s[7] != "plain")  # 3


def check_tail_per_chunk(label, counts, per_chunk=9) -> None:
    """K9 runs once at each of its 9 sites in every chunk (6 in an int8 run,
    where K10 takes the head's 3), and roi_align 7 times (the six coarse
    levels and the coarse depth): their counts must agree, chunk for
    chunk."""
    chunks = counts["roi_align"] / 7
    log({"phase": f"{label}_tail_conv_per_chunk", "chunks": chunks, "tail_conv": counts["tail_conv"]})
    if chunks < 1 or counts["tail_conv"] != per_chunk * chunks:
        raise AssertionError(f"{label}: {counts['tail_conv']} tail_conv launches for {chunks} chunks, "
                             f"not {per_chunk} a chunk")


def check_gate_per_chunk(label, counts) -> None:
    """K5 runs once at each GatedConvUnit of the fusion head in every chunk
    (9 C2F units and the head's), in every run, int8 included: 10 a
    chunk (roi_align's 7 count the chunks)."""
    chunks = counts["roi_align"] / 7
    log({"phase": f"{label}_gate_tail_per_chunk", "chunks": chunks, "gate_tail": counts["gate_tail"]})
    if chunks < 1 or counts["gate_tail"] != GATE_UNITS_PER_CHUNK * chunks:
        raise AssertionError(f"{label}: {counts['gate_tail']} gate_tail launches for {chunks} chunks, "
                             f"not {GATE_UNITS_PER_CHUNK} a chunk")


def check_quant_per_chunk(label, counts, per_chunk) -> None:
    """K10 runs once at each of its ``per_chunk`` sites in every chunk of an
    int8 run (15), and never in an exact run (0)."""
    chunks = counts["roi_align"] / 7
    log({"phase": f"{label}_quant_conv_per_chunk", "chunks": chunks, "quant_conv": counts["quant_conv"]})
    if counts["quant_conv"] != per_chunk * chunks:
        raise AssertionError(f"{label}: {counts['quant_conv']} quant_conv launches for {chunks} chunks, "
                             f"not {per_chunk} a chunk")


def check_bins_per_frame(label, counts, frames, per_frame) -> None:
    """K8 runs in the coarse branch once a frame: ``per_frame`` = (attractor
    launches, log-binomial launches), (4, 1) for the flagship's ZoeDepth
    head, (0, 0) for DA2."""
    got = (counts["attractor_update"], counts["log_binomial_depth"])
    want = (per_frame[0] * frames, per_frame[1] * frames)
    log({"phase": f"{label}_bins_launches", "frames": frames, "attractor_update": got[0],
         "log_binomial_depth": got[1], "resize": counts["resize"]})
    if got != want:
        raise AssertionError(f"{label}: {got} K8 launches for {frames} frames, not {want}")


class Frames:
    """Runs one model's tiled inference on a fixed random 2160x3840 frame;
    ``bins``: its K8 launches a frame (``check_bins_per_frame``)."""

    def __init__(self, model, lr_shape, dev, bins=(4, 1)):
        import torch

        g = torch.Generator().manual_seed(0)
        self.model, self.bins = model, bins
        self.image_lr = torch.rand((1, *lr_shape, 3), generator=g).to(dev)
        self.image_hr = torch.rand((1, 2160, 3840, 3), generator=g).to(dev)

    def infer(self, mode):
        return self.model.infer(self.image_lr, self.image_hr, mode, process_num=16)

    def first(self, mode, label, idle_ok=FRAME_IDLE_OK, int8_sites=0):
        """The first frame of a mode, with the launch counters set to 0 just
        before it and read just after: every kernel but ``idle_ok`` must
        have launched, K10 ``int8_sites`` times a chunk and K9 9 times (6
        in an int8 run). The map is the reensemble canvas for m1 and m2, the
        raw frame for rN."""
        import torch

        from patchrefinerv2_torch import ops

        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        depth, coarse = self.infer(mode)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        counts = ops.launch_counts()
        finite = bool(torch.isfinite(depth).all()) and bool(torch.isfinite(coarse).all())
        log({"phase": label, "ms": ms, "shape": list(depth.shape), "finite": finite,
             "launches": counts, "depth_mean": float(depth.mean())})
        tc = self.model.tile_cfg
        want = tc.image_raw_shape if mode.startswith("r") else tc.patch_reensemble_shape
        if tuple(depth.shape) != tuple(want) or not finite:
            raise AssertionError(f"{label}: bad output {tuple(depth.shape)} finite={finite}")
        idle = [k for k, v in counts.items() if v == 0 and k not in idle_ok]
        if idle:
            raise AssertionError(f"{label}: kernels never launched on the main path: {idle}")
        check_tail_per_chunk(label, counts, 9 - (HEAD_INT8_SITES if int8_sites else 0))
        check_gate_per_chunk(label, counts)
        check_quant_per_chunk(label, counts, int8_sites)
        check_bins_per_frame(label, counts, 1, self.bins)
        return depth, counts

    def timed(self, mode, label, n):
        """``n`` warm frames, each ended by a synchronise: host ms per frame."""
        import torch

        frames = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.time()
            self.infer(mode)
            torch.cuda.synchronize()
            frames.append((time.time() - t0) * 1e3)
        mean_ms = sum(frames) / n
        log({"phase": label, "ms_per_frame": frames, "mean_ms": mean_ms,
             "max_memory_allocated": torch.cuda.max_memory_allocated()})
        return mean_ms


def build(dev, config: str, label: str):
    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    t = time.time()
    model = PatchRefinerPlus(cfg.model.config, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.net.parameters())
    log({"phase": f"{label}_build", "seconds": time.time() - t, "params": n_params})
    return model


def flagship(dev) -> dict:
    import torch

    fr = Frames(build(dev, "configs/patchrefinerv2_zoedepth/v2_eff_u4k.py", "flagship"),
                (384, 512), dev)
    d32, _ = fr.first("m1", "m1_float32_first")
    fr.timed("m1", "m1_float32_timed", 2)
    fr.model.set_infer_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    d16, counts_m1 = fr.first("m1", "m1_bfloat16_first")
    m1_ms = fr.timed("m1", "m1_bfloat16_timed", 5)
    profile_frame(lambda: fr.infer("m1"), m1_ms, "m1_bfloat16")
    torch.cuda.reset_peak_memory_stats()
    _, counts_m2 = fr.first("m2", "m2_bfloat16_first")
    m2_ms = fr.timed("m2", "m2_bfloat16_timed", 3)
    profile_frame(lambda: fr.infer("m2"), m2_ms, "m2_bfloat16")
    # r32: the m2 stream, then 2 random chunks of 16 on the raw canvas
    torch.cuda.reset_peak_memory_stats()
    _, counts_r32 = fr.first("r32", "r32_bfloat16_first")
    r32_ms = fr.timed("r32", "r32_bfloat16_timed", 3)
    profile_frame(lambda: fr.infer("r32"), r32_ms, "r32_bfloat16")
    rel = float(((d16.float() - d32).abs() / d32.abs().clamp(min=1e-6)).mean())
    log({"phase": "m1_bf16_vs_f32", "mean_rel_diff": rel, "note": "information only"})
    return dict(m1=counts_m1, m2=counts_m2, r32=counts_r32, **int8_frames(fr, "", d16, True))


def int8_frames(fr, label, d16, flagship: bool, idle_ok=INT8_IDLE_OK) -> dict:
    """The int8 serving mode on the frame, bfloat16. For the flagship first
    the dynamic mode (no calibration: ``set_int8(None, "dynamic")``), m1
    first, timed and profiled. Then calibrate on the frame (m1 and the three
    shifted passes, process_num 16; seconds and the sites the default gates
    select, which must be the 15), then with per-channel scales m1 (first,
    timed, profiled) and, for the flagship, r32 (the JAX bench's mode:
    first, timed, profiled) and an m1 first frame with per-tensor scales;
    K10 15 times a chunk and K9 6 in each. The mean relative differences of
    the int8 m1 depths from the bfloat16 one are for information."""
    import torch

    model = fr.model
    runs = {}
    if flagship:
        model.set_int8(None, "dynamic")
        torch.cuda.reset_peak_memory_stats()
        dd, runs["m1_int8_dynamic"] = fr.first("m1", "m1_int8_dynamic_first", idle_ok,
                                               QUANT_SITES_PER_CHUNK)
        ms = fr.timed("m1", "m1_int8_dynamic_timed", 5)
        profile_frame(lambda: fr.infer("m1"), ms, "m1_int8_dynamic")
        rel = float(((dd.float() - d16.float()).abs() / d16.float().abs().clamp(min=1e-6)).mean())
        log({"phase": "m1_int8_dynamic_vs_bf16", "mean_rel_diff": rel, "note": "information only"})
        model.set_int8(None)
    torch.cuda.synchronize()
    t = time.time()
    cal = model.calibrate_int8([(fr.image_lr, fr.image_hr)], process_num=16)
    torch.cuda.synchronize()
    sel = cal.selected()
    log({"phase": f"{label}int8_calibrate", "seconds": time.time() - t, "sites": len(cal.sites),
         "selected": len(sel), "selected_sites": sel})
    if len(sel) != QUANT_SITES_PER_CHUNK:
        raise AssertionError(f"{label}int8 calibration selects {len(sel)} sites, not {QUANT_SITES_PER_CHUNK}")
    model.set_int8(cal, "perchan")
    torch.cuda.reset_peak_memory_stats()
    d8, runs[f"{label}m1_int8"] = fr.first("m1", f"{label}m1_int8_perchan_first", idle_ok,
                                           QUANT_SITES_PER_CHUNK)
    ms = fr.timed("m1", f"{label}m1_int8_perchan_timed", 5 if flagship else 3)
    profile_frame(lambda: fr.infer("m1"), ms, f"{label}m1_int8_perchan")
    rel = float(((d8.float() - d16.float()).abs() / d16.float().abs().clamp(min=1e-6)).mean())
    log({"phase": f"{label}m1_int8_vs_bf16", "mean_rel_diff": rel, "note": "information only"})
    if flagship:
        torch.cuda.reset_peak_memory_stats()
        _, runs["r32_int8"] = fr.first("r32", "r32_int8_perchan_first", idle_ok, QUANT_SITES_PER_CHUNK)
        ms = fr.timed("r32", "r32_int8_perchan_timed", 3)
        profile_frame(lambda: fr.infer("r32"), ms, "r32_int8_perchan")
        model.set_int8(cal, "tensor")
        _, runs["m1_int8_tensor"] = fr.first("m1", "m1_int8_tensor_first", idle_ok, QUANT_SITES_PER_CHUNK)
    model.set_int8(None)
    return runs


def depth_anything_v2(dev) -> dict:
    """DA2 ``plus_eff_u4k`` m1 in bfloat16: the DINOv2-L coarse branch at
    448x448 (K4 attention, bicubic K2) and the flagship's refiner and
    fusion head over 16 patches of 448x448. It has no bins head."""
    import torch

    model = build(dev, "configs/patchrefinerv2_dav2/plus_eff_u4k.py", "da2")
    model.set_infer_dtype(torch.bfloat16)
    fr = Frames(model, (448, 448), dev, bins=(0, 0))
    torch.cuda.reset_peak_memory_stats()
    bins = ("attractor_update", "log_binomial_depth")
    d16, counts = fr.first("m1", "da2_m1_bfloat16_first", idle_ok=FRAME_IDLE_OK + bins)
    ms = fr.timed("m1", "da2_m1_bfloat16_timed", 3)
    profile_frame(lambda: fr.infer("m1"), ms, "da2_m1_bfloat16")
    return dict(da2_m1=counts, **int8_frames(fr, "da2_", d16, False, INT8_IDLE_OK + bins))


def small_gpu_vs_cpu(dev) -> None:
    """The composed graph at a small size, kernels on the card against the
    plain versions on the CPU, float32: a tiny BEiT ZoeDepth coarse branch
    (head dim 16) and a ``vitt`` DA2 one (head dim 48, bicubic position
    embedding), each with the EfficientNet-B5 refiner and BiDirectionalFusion."""
    import numpy as np

    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    refiner = dict(fine_branch=dict(type="LightWeightRefiner", encoder_name="tf_efficientnet_b5_ap"))
    zoe = dict(
        image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
        fusion_feat_level=6, min_depth=1e-3, max_depth=80, strategy_refiner_target="offset_coarse",
        coarse_branch=dict(type="ZoeDepth", n_bins=16, bin_embedding_dim=16, attractor_kind="mean",
                           attractor_type="inv",
                           trunk=dict(embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3],
                                      features=32, out_channels=[24, 32, 48, 48])),
        refiner=dict(refiner, fusion_model=dict(type="BiDirectionalFusion",
                                                coarse_chl=[32, 16, 16, 16, 16, 32])))
    da2 = dict(
        zoe, image_raw_shape=[112, 168], patch_process_shape=[56, 84],
        coarse_branch=dict(type="DA2", model_cfg=dict(encoder="vitt", features=64)),
        refiner=dict(refiner, fusion_model=dict(type="BiDirectionalFusion",
                                                coarse_chl=[32, 64, 64, 64, 64, 64])))
    for name, cfg in (("zoedepth", zoe), ("da2_vitt", da2)):
        gpu = PatchRefinerPlus(cfg, device=dev, seed=3)
        cpu = PatchRefinerPlus(cfg, device="cpu", seed=3)
        rng = np.random.RandomState(11)
        lr = rng.rand(1, *cfg["patch_process_shape"], 3).astype(np.float32)
        hr = rng.rand(1, *cfg["image_raw_shape"], 3).astype(np.float32)
        for mode in ("m1", "m2", "r8"):
            dg, cg = gpu.infer(lr, hr, mode, process_num=4)
            dc, cc = cpu.infer(lr, hr, mode, process_num=4)
            err = float((dg.cpu() - dc).abs().max()) / float(dc.abs().max())
            cerr = float((cg.cpu() - cc).abs().max()) / float(cc.abs().max())
            log({"phase": f"small_{name}_{mode}_gpu_vs_cpu", "max_err_over_max": err,
                 "coarse": cerr, "tol": 1e-4})
            if not (err <= 1e-4 and cerr <= 1e-4):
                raise AssertionError(
                    f"small {name} {mode}: GPU kernels and CPU plain path disagree ({err}, {cerr})")
        if name == "zoedepth":
            small_int8_gpu_vs_cpu(gpu, cpu, lr, hr, dev)


def small_int8_gpu_vs_cpu(gpu, cpu, lr, hr, dev) -> None:
    """m1 int8 in float32 (forced) on the small flagship graph, with
    per-channel scales calibrated once on the CPU (``min_hw`` 128, the
    default 8192 scaled by the 48x64 patch's pixels: the same 15 sites) and
    carried to the card, and in the dynamic mode at the same gates. K10 must
    launch 15 times in each. Bars, the composed ones of
    tests/test_torch_quant_slice.py: mean rel < 2.5e-4 per-channel, < 6e-4
    dynamic (rel to |CPU| floored at 1e-3): the exact layers between the
    sites sum in another order on the card, and where that flips a
    rounding of ``x / sx`` a value moves by one int8 step."""
    import numpy as np

    from patchrefinerv2_torch import ops

    cal = cpu.calibrate_int8([(lr, hr)], process_num=4, min_hw=128)
    for scales, bar in (("perchan", 2.5e-4), ("dynamic", 6e-4)):
        if scales == "dynamic":
            cpu.set_int8(None, "dynamic", force=True, min_hw=128)
            gpu.set_int8(None, "dynamic", force=True, min_hw=128)
        else:
            cpu.set_int8(cal, scales, force=True)
            gpu.set_int8(cal.to(dev), scales, force=True)
        ops.reset_launches()
        dg = gpu.infer(lr, hr, "m1", process_num=4)[0].cpu().double().numpy()
        launches = ops.launch_counts()["quant_conv"]
        dc = cpu.infer(lr, hr, "m1", process_num=4)[0].double().numpy()
        rel = np.abs(dg - dc) / np.maximum(np.abs(dc), 1e-3)
        log({"phase": f"small_zoedepth_m1_int8_{scales}_gpu_vs_cpu", "selected": len(cal.selected()),
             "quant_conv_launches": launches, "max_rel": float(rel.max()), "mean_rel": float(rel.mean()),
             "tol_mean": bar})
        cpu.set_int8(None)
        gpu.set_int8(None)
        if launches != QUANT_SITES_PER_CHUNK or not rel.mean() < bar:
            raise AssertionError(f"small int8 m1 {scales}: {launches} quant_conv launches, GPU vs CPU "
                                 f"mean rel {rel.mean()}")


def synthetic_cityscapes(length: int, lr_shape):
    """Cityscapes-like frames at full size for ``Tester.run``, made with numpy
    from the index: a random 1024x2048 image (and its copy at ``lr_shape``),
    a piecewise-constant label map
    (random labels on a grid of 128x128 cells) as its color seg map, a depth
    in (1, 250) that follows the labels with a gentle ramp, and the depth's
    boundary from the port's ``get_boundaries``. ``get_metrics`` times itself
    into ``metric_ms`` and keeps each prediction in ``preds``."""
    from patchrefinerv2_torch.datasets.cityscapes import CityScapesDataset

    class Frames(CityScapesDataset):
        def __len__(self):
            return length

        def __getitem__(self, idx):
            import numpy as np

            from patchrefinerv2_torch.datasets.synthetic import resize_hwc
            from patchrefinerv2_torch.evaluation.metrics import get_boundaries

            rng = np.random.RandomState(idx)
            h, w = 1024, 2048
            image = rng.rand(h, w, 3).astype(np.float32)
            lab = np.kron(rng.randint(0, 19, (h // 128, w // 128)), np.ones((128, 128), np.int64))
            palette = rng.randint(0, 256, (19, 3))
            base = rng.uniform(2.0, 200.0, 19)
            ramp = np.linspace(0.9, 1.1, w)[None, :]
            depth = np.clip(base[lab] * ramp, 1.0, 249.0).astype(np.float32)
            return {"image_lr": resize_hwc(image, lr_shape), "image_hr": image,
                    "depth_gt": depth[..., None],
                    "boundary": get_boundaries(depth, th=1, dilation=0).numpy(),
                    "seg_image": palette[lab].astype(np.uint8),
                    "img_file_basename": f"synthetic_cs_{idx}"}

        def get_metrics(self, depth_gt, result, **kwargs):
            import torch

            torch.cuda.synchronize()
            t0 = time.time()
            out = super().get_metrics(depth_gt, result, **kwargs)
            torch.cuda.synchronize()
            self.metric_ms.append((time.time() - t0) * 1e3)
            self.preds.append(result)
            return out

    ds = Frames(min_depth=1e-3, max_depth=250)
    ds.metric_ms, ds.preds = [], []
    return ds


def pred_edge_pixels(pred, gt_shape) -> int:
    """The count of canny edge pixels that ``get_metrics`` finds in a
    prediction (resized to the gt shape, bilinear, align_corners on)."""
    import torch

    from patchrefinerv2_torch.evaluation.metrics import extract_edges
    from patchrefinerv2_torch.ops.resize import resize

    if tuple(pred.shape) != tuple(gt_shape):
        pred = resize(pred.float()[None, :, :, None].contiguous(), gt_shape, "bilinear", True)[0, :, :, 0]
    return int(extract_edges(pred.to(torch.float64), preprocess="log").sum())


class TimedModel:
    """The model behind ``Tester.run``, its ``infer`` timed on the host clock
    and ended by a synchronise."""

    def __init__(self, model):
        self.model, self.infer_ms = model, []

    def infer(self, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.time()
        out = self.model.infer(*args, **kwargs)
        torch.cuda.synchronize()
        self.infer_ms.append((time.time() - t0) * 1e3)
        return out


def cityscapes_eval(dev) -> dict:
    """``Tester.run`` at full width: ``plus_eff_cs_pretrain.py`` (the flagship
    network on 1024x2048 frames split 4x4 into 256x512 patches), bfloat16,
    random weights from seed 0, over 2 synthetic frames in m1, m2 and r32
    with process_num 16. Each mode's launch counters are set to 0 just
    before its run and read just after: every kernel of the flagship and
    canny must have launched. Every metric must be finite. With random
    weights the prediction is nearly flat: the count of its canny edge
    pixels per frame is printed (read after the counters), and
    ``eval_gpu_vs_cpu`` times ``get_metrics`` on a frame with edges."""
    import math

    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.datasets.base import DataLoader
    from patchrefinerv2_torch.evaluation.tester import Tester

    model = build(dev, "configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_pretrain.py", "cs")
    model.set_infer_dtype(torch.bfloat16)
    counts = {}
    for mode in ("m1", "m2", "r32"):
        ds = synthetic_cityscapes(2, model.patch_process_shape)
        timed = TimedModel(model)
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        metrics = Tester({}, timed, DataLoader(ds)).run(
            cai_mode=mode, process_num=16, image_raw_shape=(1024, 2048), patch_split_num=(4, 4))
        seconds = time.time() - t0
        counts[f"eval_{mode}"] = c = ops.launch_counts()
        edges = [pred_edge_pixels(p, (1024, 2048)) for p in ds.preds]
        log({"phase": f"cityscapes_eval_{mode}_bfloat16", "metrics": metrics, "seconds": seconds,
             "infer_ms_per_frame": timed.infer_ms, "metrics_ms_per_frame": ds.metric_ms,
             "pred_edge_pixels_per_frame": edges,
             "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": c})
        want = {"a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel", "see",
                "EdgeAcc", "EdgeComp", "precision", "recall", "f1"}
        if set(metrics) != want or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cityscapes eval {mode}: bad metrics {metrics}")
        idle = [k for k, v in c.items() if v == 0 and k != "quant_conv"]
        if idle:
            raise AssertionError(f"cityscapes eval {mode}: kernels never launched: {idle}")
        check_tail_per_chunk(f"cityscapes_eval_{mode}", c)
        check_gate_per_chunk(f"cityscapes_eval_{mode}", c)
        check_quant_per_chunk(f"cityscapes_eval_{mode}", c, 0)
        check_bins_per_frame(f"cityscapes_eval_{mode}", c, len(ds), (4, 1))
    return counts


def eval_gpu_vs_cpu(dev) -> None:
    """The Cityscapes metrics of one 1024x2048 frame (a gt in blocks with
    ramps and invalid rows, its color seg map, a prediction at half the size
    near the gt, so that its canny edges meet the label edges) on the card
    (K2, K11) against the CPU (plain versions): depth metrics within rel
    1e-6, boundary metrics within rel 1e-3 (the log and the hypot of the
    card and the CPU may differ in the last bit, which can flip a near-tie
    pixel). Then the time of the card's ``get_metrics`` on this frame with
    edges, and of its parts."""
    import numpy as np
    import torch

    from patchrefinerv2_torch.datasets.cityscapes import CityScapesDataset

    rng = np.random.RandomState(5)
    h, w = 1024, 2048
    yy, xx = np.mgrid[0:h, 0:w]
    lab = rng.randint(0, 19, (8, 16))[yy * 8 // h, xx * 16 // w]
    gt = rng.uniform(2.0, 200.0, 19)[lab] * (1 + 0.3 * np.sin(yy / 37.0) * np.cos(xx / 53.0))
    gt = gt.astype(np.float32)
    gt[-h // 4:] = -1.0
    seg = rng.randint(0, 256, (19, 3))[lab].astype(np.uint8)
    pred = np.clip(gt[::2, ::2], 2.0, None) * np.exp(0.05 * rng.randn(h // 2, w // 2))
    pred = torch.from_numpy(pred.astype(np.float32))
    ds = CityScapesDataset()
    got = ds.get_metrics(gt, pred.to(dev), seg_image=seg)
    ref = ds.get_metrics(gt, pred, seg_image=seg)
    errs = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in ref.items()}
    depth_keys = ("a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel")
    ok = sorted(got) == sorted(ref) and all(e <= (1e-6 if k in depth_keys else 1e-3)
                                            for k, e in errs.items())
    log({"phase": "cityscapes_metrics_gpu_vs_cpu", "metrics": got, "rel_err": errs, "ok": ok})
    if not ok:
        raise AssertionError(f"cityscapes metrics: card and CPU disagree {errs}")
    # where a frame's metrics spend their time on the card, host clock, mean of 3
    from patchrefinerv2_torch.evaluation import metrics as M

    gt_d, pred_d = torch.from_numpy(gt).to(dev), pred.to(dev)
    up = M.resize(pred_d[None, :, :, None], (h, w), "bilinear", True)[0, :, :, 0]
    edges = M.extract_edges(up, preprocess="log")
    parts = {
        "get_metrics": lambda: ds.get_metrics(gt, pred_d, seg_image=seg),
        "depth_metrics": lambda: M.compute_metrics(gt_d, pred_d, eigen_crop=False, max_depth_eval=250),
        "pred_resize": lambda: M.resize(pred_d[None, :, :, None], (h, w), "bilinear", True),
        "canny_edges": lambda: M.extract_edges(up, preprocess="log"),
        "boundary_metrics": lambda: M.compute_boundary_metrics(gt_d, up, edges, gt_d > 1e-3, edges),
    }
    breakdown = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        breakdown[name] = (time.time() - t0) * 1e3 / 3
    log({"phase": "cityscapes_metrics_breakdown_ms", "ms": breakdown,
         "pred_edge_pixels": int(edges.sum())})


def record_resize_plans() -> dict:
    """Wrap ``ops/resize._launch_plan`` so that every later K2 launch counts
    its (channels, element bytes, vec, vstore) in the returned dict."""
    import importlib

    R = importlib.import_module("patchrefinerv2_torch.ops.resize")  # the module, not ops.resize
    plan, seen = R._launch_plan, {}

    def recording(c, itemsize, align, out_row_bytes):
        out = plan(c, itemsize, align, out_row_bytes)
        key = (c, itemsize, *out)
        seen[key] = seen.get(key, 0) + 1
        return out

    R._launch_plan = recording
    return seen


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.ops import _cuda
    from patchrefinerv2_torch.ops.layer_norm import layer_norm

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log({"phase": "device", "nvidia_smi": smi, "torch": torch.cuda.get_device_name(0),
         "torch_version": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.time()
    _cuda.build()
    for name in _cuda.SOURCES:
        _cuda.library(name)
    x = torch.ones((4, 32), device=dev)
    layer_norm(x, x[0], x[0])
    torch.cuda.synchronize()
    log({"phase": "build", "seconds": time.time() - t})

    chk = Checks()
    check_kernels(chk, dev)
    check_new_kernels(chk, dev)
    check_gate_tail(chk, dev)
    check_tail_conv(chk, dev)
    check_quant_conv(chk, dev)
    check_canny(chk, dev)
    check_edge_cases(dev)
    plans = record_resize_plans()
    counts = {**flagship(dev), **depth_anything_v2(dev), **cityscapes_eval(dev)}
    log({"phase": "resize_plans_of_the_main_paths",
         "channels_itemsize_vec_vstore_launches": sorted([*k, n] for k, n in plans.items())})
    small_gpu_vs_cpu(dev)
    eval_gpu_vs_cpu(dev)

    kernels = []
    for name, k in ops.KERNELS.items():
        by_run = {run: c[name] for run, c in counts.items()}
        kernels.append(dict(
            name=name, route=k["route"], source=k["source"], replaces=k["replaces"],
            launches=sum(by_run.values()), launches_by_run=by_run, **chk.record(name)))
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
