#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):

1. the device: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build every hand-written kernel from the sources in this checkout (one
   ``nvcc`` per CUDA source, all started together, plus the Triton
   LayerNorm and bins kernels) and print the build seconds;
3. hold every kernel against its plain PyTorch version at the shapes each
   main path gives it: the flagship's and DA2's 2160x3840 frames (``PATHS``)
   in float32 (TF32 off) and bfloat16; the Cityscapes 1024x2048 frame in
   bfloat16; the raw-canvas work of r32 on both frames (``check_rn``: the
   canvases resized to the raw frame, the predictions back to the raw
   patch, the blend of 16 raw patches and finalize at raw size); the
   metrics' float32 prediction resizes to the gt shape; canny_nms at the
   evaluation's (1, 1024, 2048) in float64, where the masks must be equal,
   and float32; each with the tolerance stated, and time the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call; then, in
   float32 at small shapes, the kernels' paths the main paths do not reach
   (roi_align border bands, the other resize modes, padded and
   per-patch-init blends, ragged attention lengths and other head dims, the
   gate off and other channel counts, normed / exp / sum attractors, canny
   ties, zero gradients and maps one pixel wide or high);
4. build the flagship (``configs/patchrefinerv2_zoedepth/v2_eff_u4k.py``,
   BEiT-L/16 24 blocks + EfficientNet-B5 + BiDirectionalFusion, random
   weights from seed 0) and run a 2160x3840 frame split 4x4 with
   process_num 16: m1 in float32, then m1, m2 and r32 in bfloat16, each a
   first frame and then timed warm frames, and one profiled frame of each
   bfloat16 mode (device time by layer and its 15 costliest kernels,
   device busy share). The launch counters are set to 0 just before each
   first frame and read just after; every kernel but canny_nms must have
   launched. Outputs must be finite maps of the reensemble canvas
   (1536, 2048), or of the raw frame (2160, 3840) for r32;
5. the Depth-Anything-V2 path (``configs/patchrefinerv2_dav2/plus_eff_u4k.py``:
   DINOv2 ViT-L/14 24 blocks + DPT head at 448x448, the same refiner and
   fusion, random weights from seed 0), m1 in bfloat16 on the same frame:
   a first frame with its own launch-counter check (every kernel but the
   bins head's and canny_nms) and a finite (1792, 1792) map, timed warm
   frames, peak memory and one profiled frame;
6. the Cityscapes evaluation: ``Tester.run`` with
   ``configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_pretrain.py`` in
   bfloat16 over two synthetic 1024x2048 frames (depth, label map, gt
   boundary) in m1, m2 and r32; each mode's counters must show every
   kernel, canny_nms included, and every metric must be finite; the
   inference and metric ms and the prediction's canny edge pixels of each
   frame are printed (random weights give a nearly flat prediction, with
   no edges);
7. the same graphs at a small size on the GPU (kernels) against the CPU
   (plain versions) in float32, with a tiny BEiT and a ``vitt`` DA2 coarse
   branch: m1, m2 and r8 depth must agree; and the Cityscapes metrics of one
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
# the attention and gate_tail kernels)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
            peak=F32_FLOPS, main=True):
        """Log one check and raise if it fails; record it unless ``main`` is
        false (a dtype that the path does not run at these shapes)."""
        dname = str(dtype).replace("torch.", "")
        ok = err <= tol
        b, by = bound_ms(nbytes, flops, peak)
        log({"check": name, "path": path, "dtype": dname,
             "max_abs_err": err, "tol": tol, "ok": ok, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": b, "bound_by": by})
        if not ok:
            raise AssertionError(f"{name} ({path}, {dtype}) disagrees with its plain version: "
                                 f"{err} > {tol}")
        if not main or dname not in PATH_DTYPES[path]:  # keep the path's dtypes only
            return
        for key in (f"{path}_{SHORT[dname]}", "both"):
            r = self.rec.setdefault(name, {}).setdefault(key, dict(
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by={}))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += kernel_ms
            r["plain_ms"] += plain_ms
            r["library_ms"] = (None if library_ms is None or r["library_ms"] is None
                               else r["library_ms"] + library_ms)
            r["bound_ms"] += b
            r["by"][by] = r["by"].get(by, 0.0) + b

    def record(self, name) -> dict:
        """The kernel's numbers summed over the shapes of every path, and each
        path's own under ``<path>_<dtype>``; ``bound_by`` is the limit (bytes
        or operations) behind most of the summed bound."""
        out = {}
        for key, r in self.rec[name].items():
            out[key] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=max(r["by"], key=r["by"].get),
                            library_ms=r["library_ms"])
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


def check_kernels(chk: Checks, dev) -> None:
    """The PR 1 kernels (K1, K2 bilinear, K6, K7) at the shapes of every
    path's frame, and the rN and metric shapes."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.models.tiling import TileCfg, regular_pass
    from patchrefinerv2_torch.ops.layer_norm import layer_norm, layer_norm_plain
    from patchrefinerv2_torch.ops.resize import crop_resize, crop_resize_plain, resize, resize_plain
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
            # K1: the 7 roi_align calls of one chunk
            for h, w, c in geo["levels"]:
                f = torch.randn((1, h, w, c), generator=g, device=dev).to(dt)
                args = (f, boxes, bidx, (h, w), h / pph)
                ref = roi_align_plain(*args)
                err = err_of(roi_align(*args), ref)
                chk.add("roi_align", path, dt, err, tol_of(ref, dt), time_ms(lambda: roi_align(*args)),
                        time_ms(lambda: roi_align_plain(*args)), None,
                        f.numel() * es + 16 * 5 * 4 + ref.numel() * es, 10 * ref.numel())
                del f, ref
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


def check_new_kernels(chk: Checks, dev) -> None:
    """K3/K4 attention, K5 gate_tail, K8 bins head and bicubic K2 at the
    shapes of the flagship and DA2 frames."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.attention import attention, attention_plain, relative_position_bias
    from patchrefinerv2_torch.ops.bins import (
        attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
    )
    from patchrefinerv2_torch.ops.gated import gate_tail, gate_tail_plain
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
    # K5, gate on: C2F refinenet1's units (16 patches at half the process
    # shape, C = 256) and the full-resolution output_conv2_fusion unit at
    # the config's coarse_chl[0] channels (32 in the flagship, 128 in DA2)
    units = (("flagship", 16 * 192 * 256, 256), ("flagship", 16 * 384 * 512, 32),
             ("da2", 16 * 224 * 224, 256), ("da2", 16 * 448 * 448, 128))
    for dt in (getattr(torch, d) for d in DTYPES):
        es = torch.finfo(dt).bits // 8
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        for path, p, c in units:
            f = (torch.randn((p, c), generator=g, device=dev) * 2 + 0.3).to(dt)
            out = torch.randn((p, c), generator=g, device=dev).to(dt)
            w = (torch.randn((c, c, 1, 1), generator=g, device=dev) * c ** -0.5).to(dt)
            lw = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dt)
            lb = (torch.randn((c,), generator=g, device=dev) * 0.1).to(dt)
            args = (f, out, w, lw, lb)
            ref = gate_tail_plain(*args)
            err = err_of(gate_tail(*args), ref)
            chk.add("gate_tail", path, dt, err, tol_of(ref, dt), time_ms(lambda: gate_tail(*args)),
                    time_ms(lambda: gate_tail_plain(*args)), None,
                    3 * p * c * es + c * c * es + 2 * c * es, 2 * p * c * c + 12 * p * c, peak)
            del f, out, ref
    # K8 (flagship only): the four attractor layers of the bins head (64
    # bins, 16/8/4/1 attractors at the decoder levels r4..r1 of a 384x512
    # input) and the log-binomial depth at 384x512. Tolerance in float32:
    # 1e-5 of the magnitude for the attractors, 1e-4 for the log-binomial
    # depth (its softmax divides logits up to ~600 by temperatures down to
    # 0.0212, so a 1-ulp difference in a logarithm moves the depth by ~1e-5
    # of its range)
    for dt in (getattr(torch, d) for d in DTYPES):
        es = torch.finfo(dt).bits // 8
        for (h, w, na) in ((24, 32, 16), (48, 64, 8), (96, 128, 4), (192, 256, 1)):
            a = (torch.rand((1, h, w, na), generator=g, device=dev) * 2).to(dt)
            b = (torch.rand((1, h, w, 64), generator=g, device=dev) * 2).to(dt)
            ref = attractor_update_plain(a, b, "mean", "inv")[0]
            err = err_of(attractor_update(a, b, "mean", "inv")[0], ref)
            chk.add("attractor_update", "flagship", dt, err, tol_of(ref, dt),
                    time_ms(lambda: attractor_update(a, b, "mean", "inv")),
                    time_ms(lambda: attractor_update_plain(a, b, "mean", "inv")), None,
                    (a.numel() + 2 * b.numel()) * es, 6 * h * w * na * 64)
        pt = (torch.rand((1, 384, 512, 4), generator=g, device=dev) * 3).to(dt)
        cen = (torch.rand((1, 384, 512, 64), generator=g, device=dev) * 80).to(dt)
        args = (pt, cen, 64, 0.0212, 50.0)
        ref = log_binomial_depth_plain(*args)
        err = err_of(log_binomial_depth(*args), ref)
        tol = (1e-2 if dt == torch.bfloat16 else 1e-4) * max(float(ref.float().abs().max()), 1.0)
        chk.add("log_binomial_depth", "flagship", dt, err, tol,
                time_ms(lambda: log_binomial_depth(*args)),
                time_ms(lambda: log_binomial_depth_plain(*args)), None,
                (pt.numel() + cen.numel() + 384 * 512) * es, 384 * 512 * 64 * 12)
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
    against its plain version in float32 (not timed): roi_align samples in
    every border band of the map, resize with align_corners off and nearest
    (up and down), blending with an init pass, per-patch init flags and a
    padded patch; and the zeros the kernels write for indices outside the
    maps."""
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
    # indices outside the maps: the kernels write zeros (the plain versions raise)
    far = torch.tensor([[9, 9]], dtype=torch.int32, device=dev)
    outside = [roi_align(f, boxes[:1], torch.tensor([2], dtype=torch.int32, device=dev), (8, 8)),
               crop_resize(f[0].contiguous(), far, (4, 4), (4, 4))]
    cases += [(f"{name} out of range gives zeros", got, torch.zeros_like(got))
              for name, got in zip(("roi_align", "crop_resize"), outside)]
    cases += new_kernel_edge_cases(dev, g)
    for name, got, ref in cases:
        err, tol = err_of(got, ref), tol_of(ref, torch.float32)
        log({"check": name, "dtype": "float32", "max_abs_err": err, "tol": tol, "ok": err <= tol})
        if not err <= tol:
            raise AssertionError(f"{name}: kernel and plain version disagree: {err} > {tol}")


def new_kernel_edge_cases(dev, g) -> list:
    """(name, kernel output, plain output) in float32 for the paths of the
    attention, gate_tail, bins and bicubic kernels that the frames do not
    reach: ragged token counts (S not a multiple of the 32-query or 64-key
    tiles), head dims 16 and 48 (the small composed graphs'), non-square
    grids, two batches; the gate off and ragged row counts; normed, exp and
    sum attractors; bicubic upsampling."""
    import torch

    from patchrefinerv2_torch.ops.attention import attention, attention_plain
    from patchrefinerv2_torch.ops.bins import (
        attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
    )
    from patchrefinerv2_torch.ops.gated import gate_tail, gate_tail_plain
    from patchrefinerv2_torch.ops.resize import resize, resize_plain

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
    for p, c, gate in ((1000, 128, True), (777, 32, True), (1000, 32, False), (333, 256, False)):
        f = torch.randn((p, c), generator=g, device=dev) * 2 + 0.3
        out = torch.randn((p, c), generator=g, device=dev) if gate else None
        w = torch.randn((c, c, 1, 1), generator=g, device=dev) * c ** -0.5
        lw = torch.rand((c,), generator=g, device=dev) + 0.5
        lb = torch.randn((c,), generator=g, device=dev) * 0.1
        cases.append((f"gate_tail P={p} C={c} gate={gate}", gate_tail(f, out, w, lw, lb),
                      gate_tail_plain(f, out, w, lw, lb)))
    a = torch.rand((2, 7, 9, 3), generator=g, device=dev) * 2
    bc = torch.rand((2, 7, 9, 64), generator=g, device=dev)
    for kind, typ, normed in (("sum", "exp", False), ("mean", "exp", True), ("sum", "inv", True),
                              ("mean", "inv", True)):
        got = attractor_update(a, bc, kind, typ, normed, 1e-3, 80.0)
        ref = attractor_update_plain(a, bc, kind, typ, normed, 1e-3, 80.0)
        cases += [(f"attractor {kind} {typ} normed={normed} b_new", got[0], ref[0]),
                  (f"attractor {kind} {typ} normed={normed} centers", got[1], ref[1])]
    pt = torch.rand((3, 5, 7, 4), generator=g, device=dev) * 3
    cen = torch.sort(torch.rand((3, 5, 7, 16), generator=g, device=dev) * 10, dim=-1).values
    cases.append(("log_binomial_depth K=16", log_binomial_depth(pt, cen, 16, 5.0, 50.0),
                  log_binomial_depth_plain(pt, cen, 16, 5.0, 50.0)))
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
    ("K3/K4 attention", ("attention_kernel",)),
    ("K5 gate_tail", ("gate_tail",)),
    ("K8 bins", ("attractor_kernel", "log_binomial_kernel")),
    ("K1 roi_align", ("roi_align_kernel",)),
    ("K2 resize", ("resize_kernel",)),
    ("K6 layer_norm", ("ln_rows",)),
    ("K7 blend", ("blend_add_kernel", "blend_finalize_kernel")),
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


def profile_frame(fn, frame_ms: float, label: str) -> None:
    """One frame under torch.profiler: device time by layer, the costliest
    kernels, and the share of the unprofiled frame time the device spends
    in kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups, total, kernels = {}, 0.0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
        total += us
        kernels.append((us / 1e3, e.count, e.key[:90]))
    log({"phase": f"profile_{label}", "device_ms": total / 1e3, "frame_ms": frame_ms,
         "device_busy_share": total / 1e3 / frame_ms,
         "by_layer_ms": {g: v / 1e3 for g, v in sorted(groups.items(), key=lambda kv: -kv[1])},
         "top_kernels_ms_calls_name": sorted(kernels, reverse=True)[:15]})


# kernels that the frames do not run: canny belongs to the evaluation
FRAME_IDLE_OK = ("canny_nms",)


class Frames:
    """Runs one model's tiled inference on a fixed random 2160x3840 frame."""

    def __init__(self, model, lr_shape, dev):
        import torch

        g = torch.Generator().manual_seed(0)
        self.model = model
        self.image_lr = torch.rand((1, *lr_shape, 3), generator=g).to(dev)
        self.image_hr = torch.rand((1, 2160, 3840, 3), generator=g).to(dev)

    def infer(self, mode):
        return self.model.infer(self.image_lr, self.image_hr, mode, process_num=16)

    def first(self, mode, label, idle_ok=FRAME_IDLE_OK):
        """The first frame of a mode, with the launch counters set to 0 just
        before it and read just after: every kernel but ``idle_ok`` must
        have launched. The map is the reensemble canvas for m1 and m2, the
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
    return dict(m1=counts_m1, m2=counts_m2, r32=counts_r32)


def depth_anything_v2(dev) -> dict:
    """DA2 ``plus_eff_u4k`` m1 in bfloat16: the DINOv2-L coarse branch at
    448x448 (K4 attention, bicubic K2) and the flagship's refiner and
    fusion head over 16 patches of 448x448. It has no bins head."""
    import torch

    model = build(dev, "configs/patchrefinerv2_dav2/plus_eff_u4k.py", "da2")
    model.set_infer_dtype(torch.bfloat16)
    fr = Frames(model, (448, 448), dev)
    torch.cuda.reset_peak_memory_stats()
    _, counts = fr.first("m1", "da2_m1_bfloat16_first",
                         idle_ok=FRAME_IDLE_OK + ("attractor_update", "log_binomial_depth"))
    ms = fr.timed("m1", "da2_m1_bfloat16_timed", 3)
    profile_frame(lambda: fr.infer("m1"), ms, "da2_m1_bfloat16")
    return dict(da2_m1=counts)


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
        idle = [k for k, v in c.items() if v == 0]
        if idle:
            raise AssertionError(f"cityscapes eval {mode}: kernels never launched: {idle}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.ops import _cuda
    from patchrefinerv2_torch.ops.bins import attractor_update, log_binomial_depth
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
    attractor_update(x[:, :4].contiguous(), x)
    log_binomial_depth(x[:, :4].contiguous(), x, 32, 0.1, 50.0)
    torch.cuda.synchronize()
    log({"phase": "build", "seconds": time.time() - t})

    chk = Checks()
    check_kernels(chk, dev)
    check_new_kernels(chk, dev)
    check_canny(chk, dev)
    check_edge_cases(dev)
    counts = {**flagship(dev), **depth_anything_v2(dev), **cityscapes_eval(dev)}
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
