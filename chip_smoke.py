#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):

1. the device: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build every hand-written kernel from the sources in this checkout (one
   ``nvcc`` per CUDA source, all started together, plus the Triton
   LayerNorm) and print the build seconds;
3. hold every kernel against its plain PyTorch version at the flagship's
   shapes, in float32 (TF32 off) and bfloat16, with the tolerance stated,
   and time the kernel, the plain version and, where one PyTorch call
   computes the same function, that call; then, in float32 at small
   shapes, the kernels' paths the flagship frame does not reach (roi_align
   border bands, the other resize modes, padded and per-patch-init blends);
4. build the flagship (``configs/patchrefinerv2_zoedepth/v2_eff_u4k.py``,
   BEiT-L/16 24 blocks + EfficientNet-B5 + BiDirectionalFusion, random
   weights from seed 0) and run a 2160x3840 frame split 4x4 with
   process_num 16: m1 in float32, m1 in bfloat16 and m2 in bfloat16, each
   a first frame and then timed warm frames, and one profiled frame of
   each bfloat16 mode (device time by layer and its 15 costliest
   kernels, device busy share). The launch counters are set
   to 0 just before each first frame and read just after; every kernel
   must have launched in the m1 and in the m2 run. Outputs must be finite
   (1536, 2048) maps;
5. the same graph at a small size on the GPU (kernels) against the CPU
   (plain versions) in float32: m1 and m2 depth must agree.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX. It exits non-zero and prints no result without a CUDA device or
without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores (every kernel here is CUDA-core math)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Checks:
    """Accumulates one record per kernel across the checks."""

    def __init__(self):
        self.rec = {}

    def add(self, name, dtype, err, tol, kernel_ms, plain_ms, library_ms, nbytes, flops):
        import torch

        ok = err <= tol
        b, by = bound_ms(nbytes, flops)
        log({"check": name, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
             "tol": tol, "ok": ok, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": b, "bound_by": by})
        if not ok:
            raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {err} > {tol}")
        if dtype != torch.bfloat16:  # the main path runs bfloat16: keep those numbers
            return
        r = self.rec.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                           bytes=0.0, flops=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += kernel_ms
        r["plain_ms"] += plain_ms
        r["library_ms"] = None if library_ms is None or r["library_ms"] is None else r["library_ms"] + library_ms
        r["bytes"] += nbytes
        r["flops"] += flops


def err_of(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tol_of(ref, dtype) -> float:
    """float32: 1e-5 of the reference's magnitude (both sides compute the
    same float32 arithmetic, in another order); bfloat16: 1e-2 of it (one
    bfloat16 rounding of float32 results that may differ in the last bits)."""
    import torch

    scale = max(float(ref.float().abs().max()), 1.0)
    return (1e-2 if dtype == torch.bfloat16 else 1e-5) * scale


def check_kernels(chk: Checks, dev) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.models.tiling import TileCfg, merge_all_passes, regular_pass
    from patchrefinerv2_torch.ops.blend import TileBlender, add_pass_plain, finalize_plain
    from patchrefinerv2_torch.ops.layer_norm import layer_norm, layer_norm_plain
    from patchrefinerv2_torch.ops.masks import generate_blend_mask
    from patchrefinerv2_torch.ops.resize import crop_resize, crop_resize_plain, resize, resize_plain
    from patchrefinerv2_torch.ops.roi_align import roi_align, roi_align_plain

    g = torch.Generator(device=dev).manual_seed(1)
    tc = TileCfg((2160, 3840), (4, 4), (384, 512))
    m1 = regular_pass(tc, (0, 0), 16)
    boxes = torch.from_numpy(m1.bboxes).to(dev)
    bidx = torch.zeros(16, dtype=torch.int32, device=dev)
    # K1: the 7 roi_align calls of one chunk (6 coarse levels + coarse depth)
    levels = [(12, 16, 256), (24, 32, 256), (48, 64, 256), (96, 128, 256), (192, 256, 256),
              (384, 512, 32), (384, 512, 1)]
    for dt in (torch.float32, torch.bfloat16):
        es = torch.finfo(dt).bits // 8
        for h, w, c in levels:
            f = torch.randn((1, h, w, c), generator=g, device=dev).to(dt)
            args = (f, boxes, bidx, (h, w), h / 384)
            ref = roi_align_plain(*args)
            err = err_of(roi_align(*args), ref)
            chk.add("roi_align", dt, err, tol_of(ref, dt), time_ms(lambda: roi_align(*args)),
                    time_ms(lambda: roi_align_plain(*args)), None,
                    f.numel() * es + 16 * 5 * 4 + ref.numel() * es, 10 * ref.numel())
    # K2: crop-resize of 16 patches 540x960 -> 384x512, one feature upsample
    starts = torch.from_numpy(m1.starts_raw).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        es = torch.finfo(dt).bits // 8
        img = torch.rand((2160, 3840, 3), generator=g, device=dev).to(dt)
        ref = crop_resize_plain(img, starts, (540, 960), (384, 512))
        err = err_of(crop_resize(img, starts, (540, 960), (384, 512)), ref)
        chk.add("crop_resize", dt, err, tol_of(ref, dt),
                time_ms(lambda: crop_resize(img, starts, (540, 960), (384, 512))),
                time_ms(lambda: crop_resize_plain(img, starts, (540, 960), (384, 512))), None,
                16 * 540 * 960 * 3 * es + 16 * 2 * 4 + ref.numel() * es, 6 * ref.numel())
        del img, ref
        x = torch.randn((16, 192, 256, 256), generator=g, device=dev).to(dt)
        ref = resize_plain(x, (384, 512), "bilinear", True)
        err = err_of(resize(x, (384, 512), "bilinear", True), ref)
        lib = time_ms(lambda: F.interpolate(x.permute(0, 3, 1, 2), (384, 512), mode="bilinear",
                                            align_corners=True))
        chk.add("resize", dt, err, tol_of(ref, dt),
                time_ms(lambda: resize(x, (384, 512), "bilinear", True)),
                time_ms(lambda: resize_plain(x, (384, 512), "bilinear", True)), lib,
                x.numel() * es + ref.numel() * es, 6 * ref.numel())
        del x, ref
    # K6: a BEiT LayerNorm and a full-resolution channel LN of the fusion head
    for dt in (torch.float32, torch.bfloat16):
        es = torch.finfo(dt).bits // 8
        for m, c in ((769, 1024), (16 * 384 * 512, 32)):
            x = (torch.randn((m, c), generator=g, device=dev) * 2 + 0.5).to(dt)
            wt = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dt)
            b = torch.randn((c,), generator=g, device=dev).to(dt)
            ref = layer_norm_plain(x, wt, b, 1e-6)
            err = err_of(layer_norm(x, wt, b, 1e-6), ref)
            lib = time_ms(lambda: F.layer_norm(x, (c,), wt, b, 1e-6))
            chk.add("layer_norm", dt, err, tol_of(ref, dt), time_ms(lambda: layer_norm(x, wt, b)),
                    time_ms(lambda: layer_norm_plain(x, wt, b)), lib,
                    2 * x.numel() * es + 2 * c * es, 8 * x.numel())
    # K7: one m2 chunk of 8 overlapping patches, then finalize
    stream, initv = merge_all_passes(
        [regular_pass(tc, off, 16) for off in ((0, 0), (0, 1), (1, 0), (1, 1))], 8)
    sl = slice(8, 16)  # straddles the init pass and the first shifted pass
    st = torch.from_numpy(stream.starts_process[sl]).to(dev)
    iv = torch.from_numpy(initv[sl]).to(dev)
    valid = torch.ones(8, device=dev)
    mask = torch.from_numpy(generate_blend_mask((384, 512), border=0.15)).to(dev)
    cover = np.zeros((1536, 2048), bool)
    for y, x in stream.starts_process[sl]:
        cover[y:y + 384, x:x + 512] = True
    touched = int(cover.sum())
    for dt in (torch.float32, torch.bfloat16):
        es = torch.finfo(dt).bits // 8
        preds = (torch.rand((8, 384, 512), generator=g, device=dev) * 10).to(dt)
        # canvases as an earlier chunk leaves them: sum_wp = average * sum_w
        sum_w = torch.rand((1536, 2048), generator=g, device=dev)
        avg = torch.rand((1536, 2048), generator=g, device=dev) * 10
        base = [avg, avg * sum_w, sum_w]
        s_k = TileBlender.init((1536, 2048), dev)
        s_p = TileBlender.init((1536, 2048), dev)
        for a, b, c in zip(s_k, s_p, base):
            a.copy_(c)
            b.copy_(c)
        TileBlender.add_pass(s_k, preds, mask, st, valid=valid, initv=iv)
        add_pass_plain(s_p, preds, mask, st, valid, iv)
        err = max(err_of(a, b) for a, b in zip(s_k, s_p))
        ys, xs = np.meshgrid(np.arange(384), np.arange(512), indexing="ij")
        flat = torch.from_numpy(np.concatenate(
            [((ys + y) * 2048 + xs + x).ravel() for y, x in stream.starts_process[sl]])).to(dev)
        wp = (preds.float() * mask).reshape(-1)
        canvas = base[1].clone().view(-1)
        lib = time_ms(lambda: canvas.index_put_((flat,), wp, accumulate=True))
        chk.add("blend_add_pass", dt, err, tol_of(s_p.sum_wp, torch.float32),
                time_ms(lambda: TileBlender.add_pass(s_k, preds, mask, st, valid=valid, initv=iv)),
                time_ms(lambda: add_pass_plain(s_p, preds, mask, st, valid, iv)), lib,
                preds.numel() * es + mask.numel() * 4 + 6 * touched * 4 + 8 * 16,
                4 * preds.numel())
        ref = finalize_plain(s_p)
        err = err_of(TileBlender.finalize(s_p), ref)
        chk.add("blend_finalize", dt, err, tol_of(ref, torch.float32),
                time_ms(lambda: TileBlender.finalize(s_p)), time_ms(lambda: finalize_plain(s_p)),
                None, 4 * 1536 * 2048 * 4, 2 * 1536 * 2048)


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
    for name, got, ref in cases:
        err, tol = err_of(got, ref), tol_of(ref, torch.float32)
        log({"check": name, "dtype": "float32", "max_abs_err": err, "tol": tol, "ok": err <= tol})
        if not err <= tol:
            raise AssertionError(f"{name}: kernel and plain version disagree: {err} > {tol}")


# kernel-name fragments -> the layer they belong to (first match wins)
KERNEL_GROUPS = (
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


def flagship(dev) -> dict:
    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, "configs/patchrefinerv2_zoedepth/v2_eff_u4k.py"))
    t = time.time()
    model = PatchRefinerPlus(cfg.model.config, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.net.parameters())
    log({"phase": "flagship_build", "seconds": time.time() - t, "params": n_params})
    g = torch.Generator().manual_seed(0)
    image_lr = torch.rand((1, 384, 512, 3), generator=g).to(dev)
    image_hr = torch.rand((1, 2160, 3840, 3), generator=g).to(dev)

    def run(mode, label):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        depth, coarse = model.infer(image_lr, image_hr, mode, process_num=16)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        counts = ops.launch_counts()
        finite = bool(torch.isfinite(depth).all()) and bool(torch.isfinite(coarse).all())
        log({"phase": label, "ms": ms, "shape": list(depth.shape), "finite": finite,
             "launches": counts, "depth_mean": float(depth.mean())})
        if tuple(depth.shape) != (1536, 2048) or not finite:
            raise AssertionError(f"{label}: bad output {tuple(depth.shape)} finite={finite}")
        idle = [k for k, v in counts.items() if v == 0]
        if idle:
            raise AssertionError(f"{label}: kernels never launched on the main path: {idle}")
        return depth, counts, ms

    def timed(mode, label, n):
        """``n`` warm frames, each ended by a synchronise: host ms per frame."""
        frames = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.time()
            model.infer(image_lr, image_hr, mode, process_num=16)
            torch.cuda.synchronize()
            frames.append((time.time() - t0) * 1e3)
        mean_ms = sum(frames) / n
        log({"phase": label, "ms_per_frame": frames, "mean_ms": mean_ms,
             "max_memory_allocated": torch.cuda.max_memory_allocated()})
        return mean_ms

    d32, _, _ = run("m1", "m1_float32_first")
    timed("m1", "m1_float32_timed", 2)
    model.set_infer_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    d16, counts_m1, _ = run("m1", "m1_bfloat16_first")
    m1_ms = timed("m1", "m1_bfloat16_timed", 5)
    profile_frame(lambda: model.infer(image_lr, image_hr, "m1", process_num=16), m1_ms,
                  "m1_bfloat16")
    torch.cuda.reset_peak_memory_stats()
    _, counts_m2, _ = run("m2", "m2_bfloat16_first")
    m2_ms = timed("m2", "m2_bfloat16_timed", 3)
    profile_frame(lambda: model.infer(image_lr, image_hr, "m2", process_num=16), m2_ms,
                  "m2_bfloat16")
    rel = float(((d16.float() - d32).abs() / d32.abs().clamp(min=1e-6)).mean())
    log({"phase": "m1_bf16_vs_f32", "mean_rel_diff": rel, "note": "information only"})
    return dict(counts_m1=counts_m1, counts_m2=counts_m2)


def small_gpu_vs_cpu(dev) -> None:
    import numpy as np
    import torch

    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    cfg = dict(
        image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
        fusion_feat_level=6, min_depth=1e-3, max_depth=80, strategy_refiner_target="offset_coarse",
        coarse_branch=dict(type="ZoeDepth", n_bins=16, bin_embedding_dim=16, attractor_kind="mean",
                           attractor_type="inv",
                           trunk=dict(embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3],
                                      features=32, out_channels=[24, 32, 48, 48])),
        refiner=dict(
            fine_branch=dict(type="LightWeightRefiner", encoder_name="tf_efficientnet_b5_ap"),
            fusion_model=dict(type="BiDirectionalFusion", coarse_chl=[32, 16, 16, 16, 16, 32])))
    gpu = PatchRefinerPlus(cfg, device=dev, seed=3)
    cpu = PatchRefinerPlus(cfg, device="cpu", seed=3)
    rng = np.random.RandomState(11)
    lr = rng.rand(1, 48, 64, 3).astype(np.float32)
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    for mode in ("m1", "m2"):
        dg, cg = gpu.infer(lr, hr, mode, process_num=4)
        dc, cc = cpu.infer(lr, hr, mode, process_num=4)
        err = float((dg.cpu() - dc).abs().max()) / float(dc.abs().max())
        cerr = float((cg.cpu() - cc).abs().max()) / float(cc.abs().max())
        log({"phase": f"small_{mode}_gpu_vs_cpu", "max_err_over_max": err, "coarse": cerr,
             "tol": 1e-4})
        if not (err <= 1e-4 and cerr <= 1e-4):
            raise AssertionError(f"small {mode}: GPU kernels and CPU plain path disagree ({err}, {cerr})")


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
    check_edge_cases(dev)
    counts = flagship(dev)
    small_gpu_vs_cpu(dev)

    kernels = []
    for name, k in ops.KERNELS.items():
        r = chk.rec.get(name, {})
        b, by = bound_ms(r.get("bytes", 0.0), r.get("flops", 0.0))
        kernels.append(dict(
            name=name, route=k["route"], source=k["source"], replaces=k["replaces"],
            launches=counts.get("counts_m1", {}).get(name, 0),
            launches_m2=counts.get("counts_m2", {}).get(name, 0),
            max_abs_err=r.get("max_abs_err"), ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=b, bound_by=by, library_ms=r.get("library_ms")))
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
