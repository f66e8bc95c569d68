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
   patch, the blend of 16 raw patches and finalize at raw size); K1 (the 7
   calls of a chunk at the split's boxes), the K2 crop-resize and K7 (an m1
   and an m2 chunk, finalize) at the other readers' frames in bfloat16
   (KITTI 352x1216 split 2x4, ScanNet++ 1440x1920 and ETH3D 4032x6048
   split 2x2); the metrics' float32 prediction resizes to the gt shape; canny_nms at the
   evaluation's (1, 1024, 2048) in float64, where the masks must be equal,
   and float32, in its NMS mode and its mask mode (the eroded mask and both
   thresholds in the launch), timed in turns beside the unfused path (the
   NMS launch and the eager epilogue) and at each row count; K5 ``gate_tail`` at the 10 sites of a 16-patch chunk of
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
   ties, zero gradients and maps one pixel wide or high in both modes, and
   canny at widths and heights either side of its column strips and row
   bands on its vector and scalar paths); and the shapes
   PatchRefiner V1 gives the kernels (``check_v1_shapes``: its fine depth
   network runs on every 16-patch chunk, so K3 or K4, K6, K8 and the DPT
   neck's K2 meet batch 16, and FusionUnet's K2, K6 and K9 sites);
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
   then the time of its ``get_metrics`` on the card and of each part;
8. training, the refiner pretraining stage (``pretrain_eff_m0s1``: batch 4
   of 384x512 images against 2160x3840 depth) and stage 3 (``v2_eff_u4k``
   with ``e2e_training``: batch 4 of a 384x512 image and a 540x960 crop
   resized to 384x512 against its depth), float32 with TF32 off, remat on:
   (A) every site of the training Functions in one full-width step of each
   stage (recorded from a step on the card): K2, K5, K6 and K9 in both, K1,
   K3 and K8 in stage 3, each ``torch.autograd.Function``'s output and
   gradients against autograd through its plain version (input gradients
   1e-5, parameter gradients 1e-4 of the magnitude), with the times of its
   backward, of the plain version's and of the one library call that
   computes the gradient where there is one; (B) the pretraining stage,
   three steps through ``Trainer.run`` with the launch counters set to 0
   before each step and read after it (K2, K5, K6 and K9 in every step, no
   other kernel, no call of a plain version), finite losses and gradients,
   the parameters and BatchNorm statistics moved and a checkpoint written;
   then ms a step over 2 steps (1 with remat off) with the batch on the
   card, images/s, peak memory with remat on and off, and one profiled
   step (device ms by
   group, each Function's backward, the optimizer); (C) a tiny pretraining
   step (48x64, batch 2) on the card against the CPU within the CPU tests'
   float32 bars; (D) stage 3 from (B)'s checkpoint (``pretrained``: its
   merged and kept tensor counts printed), three steps through
   ``Trainer.run`` counted as in (B) with K1 7 and K8 4 + 1 times a step
   exactly, K3 in every step and the coarse branch moved (no checkpoint
   written: no later phase reads it), then the m1
   validation of one 2160x3840 frame in float32, the step times, peak
   memory and a profiled step as in (B); (E) a tiny stage-3 step on the
   card against the CPU within the same bars; then (B), (D) and (C) for
   PatchRefinerV2-Mobile (``pretrain_mobile_m0s1``, ``v2_mobile_u4k``),
   its steps counted without the timings and the profiled step;
9. PatchRefiner V1 (``configs/patchrefiner_zoedepth/pr_u4k.py``: two BEiT-L
   ZoeDepth networks, the fine one on every chunk, and FusionUnet), after
   the mobile frames: m1 in float32, m1 and r32 in bfloat16 on the
   2160x3840 frame with process_num 16, each first frame's launches held
   to the modules' ``kernel_calls`` chunk by chunk (``check_v1_launches``),
   timed frames with peak memory, each bfloat16 frame profiled with the fine
   network's and FusionUnet's device time apart; the DA2 V1
   (``configs/patchrefiner_dav2/pr_u4k.py``) m1 in bfloat16 alike; the V1
   Cityscapes evaluation (``pr_cs.py``, ``Tester.run`` m1 over two frames);
   a tiny V1 m1 in the small GPU-vs-CPU check; V1's training sites in (A);
   after (E) three V1 training steps of batch 4 in float32 through
   ``Trainer.run`` (the coarse branch frozen: it must not move; no
   checkpoint written), timed and profiled as in (B), and a tiny V1 step
   on the card against the CPU;
10. PatchRefinerSemi: K11 in float32 in both modes (the mask mode over the
   interior, as the loss runs it) and K12 (the bounded hysteresis) at
   the ranking loss's (4, 384, 512) (``check_semi_kernels``): K12 bit for
   bit on three masks (the canny of a seeded log-depth batch, whose loop
   exits early; a snake that runs all 128 steps; a dense random low mask
   with a sparse high one), each by the resident kernel with 1, 2, 4 and 8
   CTAs a plane and by the tiled kernel, its exit steps against the plain
   loop's, with the latency floor of the steps' barriers in one CTA and in
   clusters of 2, 4 and 8; a resident call must be one kernel event in the
   profiler; then the edge cases by both kernels (1xW, Hx1, sizes off the
   tiled kernel's tile, batch 1, planes either side of the resident
   threshold, (1, 1024, 2048), an empty high mask, a snake longer than 128
   pixels, 1, 45 and 128 steps); the ranking loss at that shape on a pseudo
   label with edges against the CPU with the same samples, K11 and K12 once
   a call (``ranking_loss_on_edges``); two steps of batch 4 through ``Trainer`` of
   each of ``SEMI_CONFIGS`` (the flagship pair with the ranking loss and
   with SSI + gradient match, and V1's pair with the ranking loss) on
   1024x2048 synthetic frames, each step's launches held to the counts of
   the student's and the teacher's modules (``semi_exact``: K11 and K12
   once with the ranking loss), no plain call, every teacher parameter
   decayed by AdamW's ``lr * wd`` alone (replayed, within an ulp), ms a
   step, peak memory; and a tiny Semi step, online and offline, and the
   student's m1 on the card against the CPU;
11. the data path (``data_run``), through the entry points on files it
   writes under ``_work/data``: 8 UnrealStereo4K frames at 2160x3840 (raw
   BGR blobs, disparities, extrinsics); the train loader's host ms a batch
   of 4 with 1 and 4 loader threads, and a sample's by transform;
   ``patchrefinerv2_torch.train.main`` on ``pretrain_eff_m0s1.py`` for 6
   steps of batch 4 on 4 loader threads (each step counted as in (B), its
   ms and its wait on the loader; from step 3 the median wait and share of
   the loop outside the step);
   ``patchrefinerv2_torch.test.main`` on ``v2_eff_u4k.py`` in m1, bfloat16,
   process_num 16 over 2 val frames (launches those of the flagship's m1
   frame, finite metrics, the ms of a frame loading, inferring and on the
   metrics), with ``--test-type consistency`` over those frames' crop
   grids (float32, process_num 4: each chunk's launches those of a
   stage-3 step's forward, the error finite) and ``--test-type
   benchmark`` on the first (m1 bfloat16: its fps within 2x of the
   flagship's frame, its FLOPs and parameters printed); then 8 Cityscapes frames at 1024x2048 (PNGs, camera json,
   sky, gtFine colour maps, offline pseudo labels): 2 steps of the offline
   Semi transfer (``plus_eff_cs_semi_offline_ssigm_ft.py``) through
   ``train.main`` on the reader's pseudo labels (the edge loss finite and
   not 0) and ``test.main`` on ``plus_eff_cs_pretrain.py`` in m1 over 2
   val frames, whose infer sample carries no ``seg_image`` (as the JAX
   reader's); after it, ``Tester.run_consistency`` and
   ``model_complexity`` of a tiny flagship on the card against the CPU
   (``tiny_tester_gpu_vs_cpu``);
12. the other readers and test types (``datasets_run``), on files it writes
   under ``_work/data``: 4 KITTI frames at 375x1242 with sparse depth
   through ``test.main`` on ``plus_eff_onlyreal.py`` in m1 and m2 (bfloat16,
   process_num 8), ``--test-type gen`` over them as a folder (each pseudo
   label equal to ``save_raw_16bit`` of the returned depth) and 2 offline
   ``semi_eff.py`` steps on those pseudo labels; 2 ScanNet++ frames at
   1440x1920 (one depth at 720x960) with the ``edge_``/``flat_`` metrics; one
   ETH3D frame at 4032x6048 with a ``.raw`` depth on the flagship split 2x2
   (peak memory printed); ``--test-type general --save`` over a raw 4K blob
   and a 1000x1500 PNG (both PNGs written per image, the bicubic read's
   host ms printed); each frame's loading, inference and metric host ms;
13. stage 1, BaselinePretrain (``baseline_run``), through
   ``patchrefinerv2_torch.train.main`` on SyntheticDataset frames, batch 4,
   float32: 3 steps of ``patchrefinerv2_zoedepth/coarse_pretrain_u4k.py``
   (BEiT-L ZoeDepth), 2 of ``patchrefinerv2_dav2/coarse_pretrain_u4k.py``
   (DINOv2-L DA2 at 448x448: K4 and the bicubic K2 under grad) and 2 of
   ``patchfusion_zoedepth/zoedepth_fine_pretrain_u4k.py`` (the fine
   target), each step's launches held to the network's ``kernel_calls``,
   with ms a step and peak memory; the ZoeDepth checkpoint loaded into
   ``v2_eff_u4k.py`` through ``pretrain_coarse_model`` on the card, every
   tensor equal; the fine network's m1 and r8 frames at 2160x3840 with
   process_num 16 (launches a chunk held, first and warm ms, finite
   depth); then a tiny DA2 step and the tiny fine target's m2 and r2 on
   the card against the CPU (``tiny_baseline_gpu_vs_cpu``). Phase 8 (A)
   also records the DA2 step's sites (path ``train_da2_backward``: K4's
   backward at (4, 16, 1025, 64), the bicubic K2's at (1, 37, 37, 1024) ->
   32x32, beside SDPA's and ``upsample_bicubic2d_backward``);
14. the Depth-Anything-V2 recipe's training (``da2_train_run``), batch 4,
   float32, each step's launches held: the DA2 refiner pretraining
   (``patchrefinerv2_dav2/pretrain_eff_m0s1.py``, 3 steps), stage 3 from
   its checkpoint (``plus_eff_u4k_base_coarse_e2e_c2f_pretrain.py``, 3
   steps: K1 7 and K4 24 a step exactly, no K3 or K8; then an m1
   validation frame), V1 (``patchrefiner_dav2/pr_u4k.py``, 3 steps, from
   ``baseline_run``'s DA2 network as both ``pretrain_*_model``: the tensors
   taken printed, the coarse branch still that network after the steps)
   and ``semi_kitti.py``'s DA2 student (2 steps on 8 written KITTI frames
   with pseudo labels, then one frame's validation with its image at
   ``KITTI_DA2_LR``, rounded by the Depth-Anything resizer through K2);
   ms a step and peak memory; then a tiny DA2 stage-3 step and a tiny DA2
   V1 step on the card against the CPU (``tiny_da2_train_gpu_vs_cpu``).
   Phase 8 (A) also records the DA2 stage-3 step's sites (path
   ``train_da2_e2e_backward``: K1 up to (448, 448, 128), K5 and K9 at
   448x448) and the DA2 V1 step's (``train_v1_da2_backward``: K4 on the
   fine crops, FusionUnet's 128-wide K9 sites).

The line before the last is one JSON object with a record per kernel: its
launches in each main-path run and their sum, and its times, bound and
largest error summed over the shapes of every path in the dtypes the path
runs (``PATH_DTYPES``), with each path's own under ``<path>_<dtype>``
(``flagship_bf16``, ``da2_bf16``, ``r32_bf16``, ``r32_f32``,
``cityscapes_eval_bf16``, ``_f32``, ``_f64``; the training Functions also
``train_backward_f32`` (the pretraining step's sites: K2, K5, K6, K9),
``train_e2e_backward_f32`` (stage 3's: those four and K1, K3, K8),
``train_v1_backward_f32`` (V1's: K2, K3, K6, K8, K9),
``train_da2_backward_f32`` (the DA2 stage-1 step's: K2 with the bicubic
one, K4, K6), ``train_da2_e2e_backward_f32`` and
``train_v1_da2_backward_f32`` (the DA2 stage-3 and V1 steps'): their
backwards over a step's sites, kept out of the sums, the error there
relative to each gradient's magnitude); ``launches_by_run`` has
``train_f32``, ``train_e2e_f32``, ``v1_train_f32`` and the three
``semi_*_f32``, the launches of one step of each, and the data runs'
(``data_u4k_train_f32`` and ``data_cs_semi_offline_f32`` a step,
``data_u4k_eval_bf16`` and ``data_cs_eval_bf16`` over 2 frames,
``data_u4k_consistency_f32`` over a frame's 4 chunks,
``data_u4k_benchmark_bf16`` over the benchmark's 9 frames; the
``datasets_*`` runs: KITTI m1, m2 and gen over 4 frames and a Semi step,
ScanNet++ over 2, ETH3D over 1, ``general`` over 2; the ``baseline_*``
runs: a step of each stage-1 run, the fine m1 and r8 frames; the DA2
runs: a step of ``da2_pretrain``, ``da2_stage3``, ``v1_da2_train`` and
``da2_semi_kitti``, and that run's validation frame); K1, the K2
crop-resize and K7 also record ``kitti_bf16``, ``scannet_bf16``,
``eth3d_bf16`` and ``da2_kitti_f32`` (with K2's resizer image resize);
K11 and K12 also record
``semi_f32``, the Semi loss's shape (K11 its mask mode's time with the NMS
mode's, the unfused path's and each row count's as extras; K12 also its exit step, the tiled
kernel's time, the latency floor and its time and exit step on the snake
and the dense mask). The line before the device's name has the run's total
seconds, the build included. The last line is ``{"ok": true, "device": {...}}``.
The script imports nothing of JAX. It exits non-zero and prints no result
without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
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
# Cityscapes evaluation's flagship network over a 1024x2048 frame, each split
# 4x4, one chunk of 16 patches; the evaluations of the other readers' frames
# by the flagship network (``datasets_run``): KITTI's 352x1216 split 2x4 (its
# 176x304 patches upsampled to 384x512, one chunk of 8), ScanNet++'s
# 1440x1920 and ETH3D's 4032x6048 split 2x2 (one chunk of 4; ETH3D's
# 2016x3024 patches downsampled ~5.9x), and the DA2 student's KITTI
# validation frame (``da2_train_run``: 448x448 patches, float32), where only
# the kernels whose shapes the split sets are checked (``tiles_only``: K1,
# the K2 crop-resize, K7; and ``check_metric_resizes``, the K2 resize of the
# canvas to the gt; ``resizer``: the K2 image resize of the Depth-Anything
# resizer; ``tail_batches``: the chunks K9 is checked at, 16 and 8 patches
# unless the path says, as the validation's chunks of 4 do).
# Levels: the six coarse levels and the coarse depth that roi_align crops,
# (h, w, C). ``dtypes``: those the frame's kernels are checked in (the
# evaluations run bfloat16 only).
FLAGSHIP_LEVELS = [(12, 16, 256), (24, 32, 256), (48, 64, 256), (96, 128, 256), (192, 256, 256),
                   (384, 512, 32), (384, 512, 1)]
DA2_LEVELS = [(16, 16, 256), (32, 32, 256), (64, 64, 256), (128, 128, 256), (256, 256, 256),
              (448, 448, 128), (448, 448, 1)]
# the DA2 KITTI validation's image_lr: sides that the Depth-Anything resizer
# rounds to the 448x448 patches (the val loader's own 384x512 rounds to
# 378x518, which the coarse-conditioned refiner cannot take, in the JAX
# package neither: ``PatchRefinerPlus._check_coarse_map``)
KITTI_DA2_LR = (444, 452)
PATHS = {
    "flagship": dict(frame=(2160, 3840), split=(4, 4), process=(384, 512), levels=FLAGSHIP_LEVELS,
                     dtypes=("float32", "bfloat16")),
    "da2": dict(frame=(2160, 3840), split=(4, 4), process=(448, 448), levels=DA2_LEVELS,
                dtypes=("float32", "bfloat16")),
    "cityscapes_eval": dict(frame=(1024, 2048), split=(4, 4), process=(384, 512),
                            levels=FLAGSHIP_LEVELS, dtypes=("bfloat16",)),
    "kitti": dict(frame=(352, 1216), split=(2, 4), process=(384, 512), levels=FLAGSHIP_LEVELS,
                  dtypes=("bfloat16",), tiles_only=True),
    "scannet": dict(frame=(1440, 1920), split=(2, 2), process=(384, 512), levels=FLAGSHIP_LEVELS,
                    dtypes=("bfloat16",), tiles_only=True),
    "eth3d": dict(frame=(4032, 6048), split=(2, 2), process=(384, 512), levels=FLAGSHIP_LEVELS,
                  dtypes=("bfloat16",), tiles_only=True),
    "da2_kitti": dict(frame=(352, 1216), split=(2, 4), process=(448, 448), levels=DA2_LEVELS,
                      dtypes=("float32",), tiles_only=True, resizer=KITTI_DA2_LR, tail_batches=(4,)),
}


# the dtypes each main path runs its kernels in: the frames in bfloat16 (with
# float32 canvases, which rN resizes and finalizes at raw size); the
# Cityscapes evaluation also resizes its float32 prediction to the gt and
# runs canny in float64 (the JAX host path's dtype). r32 is the flagship's
# r32 frame's raw-canvas work.
PATH_DTYPES = {"flagship": ("bfloat16",), "da2": ("bfloat16",), "r32": ("bfloat16", "float32"),
               "cityscapes_eval": ("bfloat16", "float32", "float64"),
               "v1": ("bfloat16",), "v1_da2": ("bfloat16",),
               "train_backward": ("float32",), "train_e2e_backward": ("float32",),
               "train_v1_backward": ("float32",), "train_da2_backward": ("float32",),
               "train_da2_e2e_backward": ("float32",), "train_v1_da2_backward": ("float32",),
               "da2_kitti": ("float32",),
               "semi": ("float32",),
               "kitti": ("bfloat16", "float32"), "scannet": ("bfloat16", "float32"),
               "eth3d": ("bfloat16", "float32")}
SHORT = {"bfloat16": "bf16", "float32": "f32", "float64": "f64"}


class Checks:
    """Accumulates, per kernel, the shapes checked for each main path in the
    dtypes that path runs, and for all paths together."""

    def __init__(self):
        self.rec = {}

    def add(self, name, path, dtype, err, tol, kernel_ms, plain_ms, library_ms, nbytes, flops,
            peak=F32_FLOPS, main=True, extra=None, in_sum=True):
        """Log one check and raise if it fails; record it unless ``main`` is
        false (a dtype that the path does not run at these shapes).
        ``extra``: more times of the check, logged and summed into the
        record under their names. ``in_sum=False`` keeps it out of the sum
        over the paths (the training backwards are another function than
        the kernel's)."""
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
        for key in (f"{path}_{SHORT[dname]}",) + (("both",) if in_sum else ()):
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
    return float((a.detach().float() - b.detach().float()).abs().max())


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


def crop_read_bytes(tc, starts, es: int) -> int:
    """The bytes the crop-resize must fetch from the (H, W, 3) frame: the
    32-byte sectors that its bilinear align-corners taps touch, in every
    source row a tap reads (all rows and columns when it upsamples; at
    ETH3D's ~5.9x downsample the tapped columns lie closer than a sector,
    so each such row's whole span). ``starts``: the patches' (h, w) origins."""
    import numpy as np

    from patchrefinerv2_torch.ops.resize import axis_taps

    (prh, prw), (pph, ppw) = tc.patch_raw_shape, tc.patch_process_shape
    iy, wy = axis_taps(prh, pph, "bilinear", True)
    ix, wx = axis_taps(prw, ppw, "bilinear", True)
    rows = np.unique(iy[wy != 0]).astype(np.int64)
    cols = np.unique(ix[wx != 0]).astype(np.int64)
    offsets = ((cols[:, None] * 3 + np.arange(3)) * es).ravel()  # in a row, from its patch's left
    total = 0
    for y0, x0 in np.asarray(starts, np.int64):
        row_start = ((y0 + rows) * tc.image_raw_shape[1] + x0) * 3 * es
        phases, n_rows = np.unique(row_start % 32, return_counts=True)
        for phase, n in zip(phases, n_rows):
            total += int(n) * len(np.unique((phase + offsets) // 32)) * 32
    return total


def check_kernels(chk: Checks, dev) -> None:
    """The PR 1 kernels (K1, K2 bilinear, K6, K7) at the shapes of every
    path's frame (one chunk of the path's split; ``tiles_only`` paths K1,
    the K2 crop-resize and K7), the rN shapes, and the metric resizes of
    the Cityscapes, KITTI, ScanNet++ and ETH3D evaluations."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.models.backbones.dpt import da_round
    from patchrefinerv2_torch.models.tiling import TileCfg, regular_pass
    from patchrefinerv2_torch.ops.resize import crop_resize, crop_resize_plain
    from patchrefinerv2_torch.ops.roi_align import launch_plan as roi_plan
    from patchrefinerv2_torch.ops.roi_align import roi_align, roi_align_plain

    g = torch.Generator(device=dev).manual_seed(1)
    for path, geo in PATHS.items():
        pph, ppw = geo["process"]
        tc = TileCfg(geo["frame"], geo["split"], (pph, ppw))
        prh, prw = tc.patch_raw_shape
        n = geo["split"][0] * geo["split"][1]
        m1 = regular_pass(tc, (0, 0), n)
        boxes = torch.from_numpy(m1.bboxes).to(dev)
        bidx = torch.zeros(n, dtype=torch.int32, device=dev)
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
                fx = f.float().permute(0, 3, 1, 2).expand(n, c, h, w)
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
                        f.numel() * es + n * 5 * 4 + ref.numel() * es, 10 * ref.numel())
                del f, ref, lib_out, fx
            # K2: crop-resize of the n raw patches -> the process shape (the
            # bytes of the source sectors its taps touch)
            img = torch.rand((*tc.image_raw_shape, 3), generator=g, device=dev).to(dt)
            crop = (img, starts, (prh, prw), (pph, ppw))
            ref = crop_resize_plain(*crop)
            err = err_of(crop_resize(*crop), ref)
            chk.add("crop_resize", path, dt, err, tol_of(ref, dt), time_ms(lambda: crop_resize(*crop)),
                    time_ms(lambda: crop_resize_plain(*crop)), None,
                    crop_read_bytes(tc, m1.starts_raw, es) + n * 2 * 4 + ref.numel() * es,
                    6 * ref.numel())
            del img, ref
            if geo.get("resizer"):  # the Depth-Anything resizer's image resize
                check_bilinear(chk, path, dt, g, dev, (1, *geo["resizer"], 3), da_round(geo["resizer"]))
            if geo.get("tiles_only"):
                continue
            # K2 bilinear: C2F refinenet1's x2 upsample of 16 patches at 256
            # channels; DA2 also the DPT head's 256x256 -> 448x448 at 128
            ups = [(16, pph // 2, ppw // 2, 256)] + ([(1, 256, 256, 128)] if path == "da2" else [])
            for shape in ups:
                check_bilinear(chk, path, dt, g, dev, shape, (pph, ppw))
            # K6: a trunk LayerNorm (769 BEiT or 1025 DINOv2 tokens) and the
            # fusion head's full-resolution 32-channel LN
            tokens = 769 if path == "flagship" else 1025
            for m, c in ((tokens, 1024), (16 * pph * ppw, 32)):
                check_layer_norm(chk, path, dt, g, dev, m, c)
        check_blend(chk, dev, g, path, tc, geo["dtypes"])
    flagship_tc = TileCfg(PATHS["flagship"]["frame"], (4, 4), PATHS["flagship"]["process"])
    cs_tc = TileCfg(PATHS["cityscapes_eval"]["frame"], (4, 4), PATHS["cityscapes_eval"]["process"])
    check_rn(chk, dev, g, "r32", flagship_tc)
    check_rn(chk, dev, g, "cityscapes_eval", cs_tc)
    check_metric_resizes(chk, dev, g, "cityscapes_eval", cs_tc)
    for path in ("kitti", "scannet", "eth3d", "da2_kitti"):
        geo = PATHS[path]
        check_metric_resizes(chk, dev, g, path, TileCfg(geo["frame"], geo["split"], geo["process"]))


def check_bilinear(chk: Checks, path, dt, g, dev, shape, size) -> None:
    """K2's bilinear align-corners resize of an NHWC ``shape`` to ``size``;
    the library call is ``F.interpolate``."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    es = torch.finfo(dt).bits // 8
    x = torch.randn(shape, generator=g, device=dev).to(dt)
    ref = resize_plain(x, size, "bilinear", True)
    err = err_of(resize(x, size, "bilinear", True), ref)
    lib = time_ms(lambda: F.interpolate(x.permute(0, 3, 1, 2), size, mode="bilinear", align_corners=True))
    chk.add("resize", path, dt, err, tol_of(ref, dt), time_ms(lambda: resize(x, size, "bilinear", True)),
            time_ms(lambda: resize_plain(x, size, "bilinear", True)), lib,
            x.numel() * es + ref.numel() * es, 6 * ref.numel())


def check_layer_norm(chk: Checks, path, dt, g, dev, m: int, c: int) -> None:
    """K6 over ``m`` rows of ``c``; the library call is ``F.layer_norm``."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.layer_norm import layer_norm, layer_norm_plain

    es = torch.finfo(dt).bits // 8
    x = (torch.randn((m, c), generator=g, device=dev) * 2 + 0.5).to(dt)
    wt = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dt)
    b = torch.randn((c,), generator=g, device=dev).to(dt)
    ref = layer_norm_plain(x, wt, b, 1e-6)
    err = err_of(layer_norm(x, wt, b, 1e-6), ref)
    lib = time_ms(lambda: F.layer_norm(x, (c,), wt, b, 1e-6))
    chk.add("layer_norm", path, dt, err, tol_of(ref, dt), time_ms(lambda: layer_norm(x, wt, b)),
            time_ms(lambda: layer_norm_plain(x, wt, b)), lib, 2 * x.numel() * es + 2 * c * es,
            8 * x.numel())


def blend_chunks(path: str, tc) -> list:
    """The (starts on the canvas, init flags) of the chunks ``check_blend``
    blends: for the flagship and the Cityscapes frame an m2 chunk of 8
    overlapping patches that straddles the init pass and the first shifted
    pass; for DA2 the m1 init pass of 16 patches; for the other readers'
    frames the m1 init pass of their split and the m2 chunk after the first
    (``min(patches, 8)`` patches)."""
    import numpy as np

    from patchrefinerv2_torch.models.tiling import merge_all_passes, regular_pass

    n = tc.patch_split_num[0] * tc.patch_split_num[1]
    chunk = min(n, 8)
    m1 = (regular_pass(tc, (0, 0), n).starts_process, np.ones(n, np.float32))
    stream, initv = merge_all_passes(
        [regular_pass(tc, off, n) for off in ((0, 0), (0, 1), (1, 0), (1, 1))], chunk)
    m2 = (stream.starts_process[chunk:2 * chunk], initv[chunk:2 * chunk])
    if PATHS[path].get("tiles_only"):
        return [m1, m2]
    return [m1] if path == "da2" else [m2]


def check_blend(chk: Checks, dev, g, path, tc, dtypes) -> None:
    """K7 on each chunk of ``blend_chunks``, blended into canvases as an
    earlier chunk leaves them. Then finalize."""
    for starts_np, initv in blend_chunks(path, tc):
        check_blend_chunk(chk, dev, g, path, tc, dtypes, starts_np, initv)


def check_blend_chunk(chk: Checks, dev, g, path, tc, dtypes, starts_np, initv) -> None:
    import numpy as np
    import torch

    from patchrefinerv2_torch.ops.blend import TileBlender, add_pass_plain, finalize_plain
    from patchrefinerv2_torch.ops.masks import generate_blend_mask

    pph, ppw = tc.patch_process_shape
    canvas_hw = tc.patch_reensemble_shape
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


def check_metric_resizes(chk: Checks, dev, g, path: str, tc) -> None:
    """K2 in the metrics of an m1 or m2 frame of ``path``: the float32
    prediction on the reensemble canvas to the gt shape, bilinear with
    align_corners off (the depth metrics) and on (the Cityscapes boundary
    metrics; the other readers' metrics do not run it, so there it is
    checked but not recorded)."""
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
        chk.add("resize", path, x.dtype, err, tol_of(ref, x.dtype),
                time_ms(lambda: resize(x, size, "bilinear", ac)),
                time_ms(lambda: resize_plain(x, size, "bilinear", ac)), lib,
                4 * (x.numel() + ref.numel()), 6 * ref.numel(),
                main=not ac or path == "cityscapes_eval")
        del ref


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


def check_attention(chk: Checks, path, dt, g, dev, batch: int, s: int, grid) -> None:
    """K3 (with the BEiT relative-position bias of ``grid``) or K4 (``grid``
    None) over ``batch`` images of S tokens, 16 heads of 64: q, k, v are the
    heads of one packed qkv projection, as in the blocks. Tolerance: max
    error / max |o| < 1e-5 in float32, 1e-2 in bfloat16. The library call is
    ``scaled_dot_product_attention`` with the bias as a float mask."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.attention import attention, attention_plain, relative_position_bias

    es = torch.finfo(dt).bits // 8
    peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
    qkv = torch.randn((batch, s, 3, 16, 64), generator=g, device=dev).to(dt)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    table = None
    if grid is not None:
        table = torch.randn(((2 * grid[0] - 1) * (2 * grid[1] - 1) + 3, 16), generator=g,
                            device=dev).to(dt)
    args = (q, k, v, 0.125, table, grid)
    ref = attention_plain(*args)
    err = err_of(attention(*args), ref)
    tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(ref.float().abs().max())
    mask = None if grid is None else relative_position_bias(table, grid)[None].to(dt)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.125))
    chk.add("attention", path, dt, err, tol, time_ms(lambda: attention(*args)),
            time_ms(lambda: attention_plain(*args)), lib,
            4 * batch * 16 * s * 64 * es + (0 if table is None else table.numel() * es),
            4 * batch * 16 * s * s * 64, peak)


def check_bins(chk: Checks, path, dt, g, dev, batch: int) -> None:
    """K8 at ``BINS_CALLS`` over ``batch`` images, each call with the resize
    of the centres it takes in. Tolerance in float32: 1e-5 of the magnitude
    for the attractors, 1e-4 for the log-binomial depth (its softmax divides
    logits up to ~600 by temperatures down to 0.0212, so a 1-ulp difference
    in a logarithm moves the depth by ~1e-5 of its range). Beside each: the
    time of the K2 resize that the call took in before
    (``absorbed_resize_ms``, the same shapes); the bound is the larger of
    the bytes (the coarse centres, not the upsampled ones) and the
    function's operations (``bins_operations``) at the float32 rate outside
    the tensor cores, in bfloat16 too (the data sheet gives no bfloat16 rate
    outside them)."""
    import torch

    from patchrefinerv2_torch.ops.bins import (
        attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
    )
    from patchrefinerv2_torch.ops.resize import resize

    es = torch.finfo(dt).bits // 8
    for (h, w), (oh, ow), na in BINS_CALLS:
        b = (torch.rand((batch, h, w, 64), generator=g, device=dev) * (80 if na == 0 else 2)).to(dt)
        before = time_ms(lambda: resize(b, (oh, ow), "bilinear", True))
        if na:
            a = (torch.rand((batch, oh, ow, na), generator=g, device=dev) * 2).to(dt)
            args, name = (a, b, "mean", "inv"), "attractor_update"
            fn, plain = attractor_update, attractor_update_plain
            nbytes = (a.numel() + b.numel() + batch * oh * ow * 64) * es
        else:
            a = (torch.rand((batch, oh, ow, 4), generator=g, device=dev) * 3).to(dt)
            args, name = (a, b, 64, 0.0212, 50.0), "log_binomial_depth"
            fn, plain = log_binomial_depth, log_binomial_depth_plain
            nbytes = (a.numel() + b.numel() + batch * oh * ow) * es
        ref, got = plain(*args), fn(*args)
        if na:
            ref, got = ref[0], got[0]
            tol = tol_of(ref, dt)
        else:
            tol = (1e-2 if dt == torch.bfloat16 else 1e-4) * max(float(ref.float().abs().max()), 1.0)
        chk.add(name, path, dt, err_of(got, ref), tol, time_ms(lambda: fn(*args)),
                time_ms(lambda: plain(*args)), None, nbytes,
                bins_operations(batch * oh * ow, 64, na, (h, w) != (oh, ow)),
                extra=dict(absorbed_resize_ms=before))
        del a, b, ref, got, args


def check_new_kernels(chk: Checks, dev) -> None:
    """K3/K4 attention, K8 bins head (``BINS_CALLS``) and bicubic K2 at the
    shapes of the flagship and DA2 frames."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.resize import resize, resize_plain

    g = torch.Generator(device=dev).manual_seed(3)
    # K3: one BEiT-L block at 384x512 (S = 769, grid 24x32, bias from the
    # table); K4: one DINOv2-L block at 448x448 (S = 1025, no bias)
    for dt in (getattr(torch, d) for d in DTYPES):
        for path, s, grid in (("flagship", 769, (24, 32)), ("da2", 1025, None)):
            check_attention(chk, path, dt, g, dev, 1, s, grid)
    # K8 (flagship only): BINS_CALLS of one image
    for dt in (getattr(torch, d) for d in DTYPES):
        check_bins(chk, "flagship", dt, g, dev, 1)
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
    and 8 (m2's chunks) at the process shape, or the path's
    ``tail_batches``, in float32 (TF32 off) and bfloat16 as ``PATHS`` lists
    them. The first chunk size is recorded; the others are checked and
    logged. Tolerance: float32 1e-5 of the
    output's magnitude (the same float32 sums in another order); bfloat16
    1e-2 of it (both sides round the same float32 result once, and a sum in
    another order can cross a rounding boundary). Bound: each input read
    once (the GatedConvUnit's residual is its input), the weights, the
    output written once; operations 2 * P * k^2 * Cin * Cout, bf16 on the
    tensor cores. The library call is one ``F.conv2d`` (with its bias) on
    the input concatenated beforehand; the ``torch.cat`` is timed beside
    it. Then the edge cases in both dtypes (not timed)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(6)
    for path, geo in PATHS.items():
        h2 = geo["levels"][-2][2]
        for dt in (getattr(torch, d) for d in geo["dtypes"]):
            for batch in geo.get("tail_batches", (16, 8)):
                for site in tail_sites(h2):
                    check_tail_site(chk, path, dt, g, dev, (batch, *geo["process"]), site)
    tail_edge_cases(dev, g)


def check_tail_site(chk: Checks, path, dt, g, dev, shape, site) -> None:
    """K9 at one site (``tail_sites``' form) of a chunk of ``shape`` (N, H,
    W), recorded for the path's first chunk size (16 patches unless its
    ``tail_batches`` say) and logged with its launch plan."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.tail_conv import launch_plan as tail_plan
    from patchrefinerv2_torch.ops.tail_conv import tail_conv, tail_conv_plain

    name, widths, k, cout, ep = site
    es = torch.finfo(dt).bits // 8
    peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
    npx = shape[0] * shape[1] * shape[2]
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
    chk.add("tail_conv", path, dt, err, tol_of(ref, dt), time_ms(lambda: tail_conv(parts, **kw)),
            time_ms(lambda: tail_conv_plain(parts, **kw)), lib, nbytes,
            2 * npx * k * k * cin * cout, peak,
            main=shape[0] == PATHS.get(path, {}).get("tail_batches", (16,))[0])
    log({"tail_conv_site": name, "path": path, "dtype": str(dt)[6:], "batch": shape[0],
         "in": list(widths), "k": k, "out": cout, "cat_ms": cat_ms,
         "plan": tail_plan(widths, k, cout, dt)})


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


# PatchRefiner V1 (its fine branch a whole depth network run on every chunk,
# its head FusionUnet): (config, process shape, the trunk's tokens, the BEiT
# grid or None for DINOv2, its DPT neck's K2 upsamples at a chunk's batch)
V1_CONFIG = "configs/patchrefiner_zoedepth/pr_u4k.py"
V1_DA2_CONFIG = "configs/patchrefiner_dav2/pr_u4k.py"
V1_PATHS = {
    # the MiDaS neck: refinenet1's x2 upsample, output_conv's 128 channels x2
    "v1": (V1_CONFIG, (384, 512), 769, (24, 32), [((96, 128, 256), (192, 256)),
                                                  ((192, 256, 128), (384, 512))]),
    # the DA2 head: its 128-channel out_feat to the patch
    "v1_da2": (V1_DA2_CONFIG, (448, 448), 1025, None, [((256, 256, 128), (448, 448))]),
}


def meta_net(config: str):
    """The network of ``config`` (V1 or V2) on the meta device: its widths,
    without its weights."""
    import torch

    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.models.patchrefinerplus import PRPlusNet

    cfg = Config.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)), config))
    with torch.device("meta"):
        return PRPlusNet(cfg.model.config, v1=cfg.model.get("type") == "PatchRefiner")


def v1_tail_sites(head) -> list:
    """FusionUnet's K9 sites in a chunk, from its modules, in ``tail_sites``'
    form: the level-0 encoder layers (cat(coarse, fine) level 0; then h,
    pred1, pred2) with LN and GELU, the last decoder stage's second conv
    with GELU and ``final_conv`` with ``update_base`` and the clamp."""
    e1, e2 = head.encoder_layers_1[0].single_conv[0], head.encoder_layers_2[0].single_conv[0]
    d = head.decoder_layers[-1].conv.double_conv[2]
    c0 = e1.in_channels // 2  # the coarse and the fine network are of one kind
    return [("encoder_layers_1.0", (c0, c0), 3, e1.out_channels, dict(ln=True, act="gelu")),
            ("encoder_layers_2.0", (e2.in_channels - 2, 1, 1), 3, e2.out_channels,
             dict(ln=True, act="gelu")),
            ("decoder_layers.4 conv 2", (d.in_channels,), 3, d.out_channels, dict(act="gelu")),
            ("final_conv", (head.final_conv.in_channels,), 3, 1, dict(residual="map", act="relu"))]


def check_v1_shapes(chk: Checks, dev) -> None:
    """The kernels at the shapes V1 gives them that no V2 path does, each in
    float32 (TF32 off) and bfloat16 (recorded for ``v1`` and ``v1_da2`` in
    bfloat16), 16 patches a chunk: K3 (BEiT) or K4 (DINOv2) over the chunk,
    K6 at the fine trunk's 16 x S rows of 1024 and at FusionUnet's level-1
    LayerNorm (the widest it runs on K6), K8's four attractor layers and the
    log-binomial depth at batch 16 (``BINS_CALLS``), K2 at the fine DPT
    neck's upsamples and FusionUnet's resize of the depths to level 1, and
    K9 at FusionUnet's 4 sites (``v1_tail_sites``, 16- and 8-patch chunks).
    K1 and K7 meet the flagship's shapes (the same coarse levels and
    frame)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(14)
    for path, (config, (ph, pw), s, grid, ups) in V1_PATHS.items():
        head = meta_net(config).refiner_fusion_model
        c1 = head.encoder_layers_1[1].single_conv[0].out_channels
        sites = v1_tail_sites(head)
        for dt in (torch.float32, torch.bfloat16):
            check_attention(chk, path, dt, g, dev, 16, s, grid)
            check_layer_norm(chk, path, dt, g, dev, 16 * s, 1024)
            check_layer_norm(chk, path, dt, g, dev, 16 * (ph // 2) * (pw // 2), c1)
            if grid is not None:
                check_bins(chk, path, dt, g, dev, 16)
            for shape, size in ups + [((ph, pw, 1), (ph // 2, pw // 2))]:
                check_bilinear(chk, path, dt, g, dev, (16, *shape), size)
            for batch in (16, 8):
                for site in sites:
                    check_tail_site(chk, path, dt, g, dev, (batch, ph, pw), site)
            torch.cuda.empty_cache()


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


def unfused_masks(maps, lo: float, hi: float, region=None):
    """The callers' (low, high) masks as the port computed them before K11's
    mask mode: the NMS launch, then the epilogue in eager ops (the loss's
    interior built in two)."""
    import torch

    from patchrefinerv2_torch.ops.canny import canny_nms

    lm, mag = canny_nms(*maps), maps[2]
    if region is None:
        region = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
        region[..., 1:-1, 1:-1] = True
    lm = lm & region & (mag > 0)
    return lm & (mag >= lo), lm & (mag >= hi)


def check_k11(chk: Checks, path: str, maps, lo: float, hi: float, region=None, main: bool = True) -> None:
    """K11 on the (B, H, W) ``maps`` in both modes against the plain
    versions: float64 bit for bit, float32 at most 1e-4 of the pixels
    differing (the error is the share of pixels whose mask differs; the
    counts are logged). Recorded: the mask mode, which the path runs, with
    the NMS mode's time, plain time and bound, the unfused path's time (the
    NMS launch and the old eager epilogue; timed in turns with the mask
    mode: fused, unfused, unfused, fused), each row count's and the scalar
    path's time as extras. Bounds count each map read once (3 x 4 or 8
    bytes a pixel) and each mask written once (1 byte; the mask mode 2,
    and 1 more read with a ``region``)."""
    import torch

    from patchrefinerv2_torch.ops import _cuda
    from patchrefinerv2_torch.ops.canny import (
        NMS_ROWS, canny_nms, canny_nms_masks, canny_nms_masks_plain, canny_nms_plain, canny_nms_plan,
        nms_launch,
    )

    mag = maps[2]
    dt, n, eb = mag.dtype, mag.numel(), mag.element_size()
    h, w = mag.shape[-2:]
    tol = 0.0 if dt == torch.float64 else 1e-4
    lm, ref = canny_nms(*maps), canny_nms_plain(*maps)
    nms_differ = int((lm != ref).sum())
    nms_ms, nms_plain_ms = time_ms(lambda: canny_nms(*maps)), time_ms(lambda: canny_nms_plain(*maps))
    chk.add("canny_nms", path, dt, nms_differ / n, tol, nms_ms, nms_plain_ms, None, 3 * n * eb + n, 20 * n,
            main=False, extra={"mode": "nms"})
    (low, high), (r_low, r_high) = (canny_nms_masks(*maps, lo, hi, region),
                                    canny_nms_masks_plain(*maps, lo, hi, region))
    differ = int(((low != r_low) | (high != r_high)).sum())
    def fused():
        return canny_nms_masks(*maps, lo, hi, region)

    def unfused():
        return unfused_masks(maps, lo, hi, region)

    turns = [time_ms(f) for f in (fused, unfused, unfused, fused)]
    fused_ms, unfused_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    extra = {"nms_ms": nms_ms, "nms_plain_ms": nms_plain_ms,
             "nms_bound_ms": bound_ms(3 * n * eb + n, 20 * n)[0], "unfused_ms": unfused_ms,
             **{f"rows_{r}_ms": time_ms(lambda r=r: nms_launch(*maps, True, lo, hi, region, rows=r))
                for r in NMS_ROWS},
             "scalar_ms": time_ms(lambda: nms_launch(*maps, True, lo, hi, region, vector=False))}
    chk.add("canny_nms", path, dt, differ / n, tol, fused_ms,
            time_ms(lambda: canny_nms_masks_plain(*maps, lo, hi, region)), None,
            3 * n * eb + 2 * n + (n if region is not None else 0), 20 * n, main=main,
            extra={**extra, "mode": "masks"} if not main else extra)
    log({"check": "canny_nms pixels", "path": path, "dtype": str(dt)[6:], "shape": list(mag.shape),
         "region": "mask" if region is not None else "interior", "nms_differ": nms_differ,
         "masks_differ": differ, "of": n, "local_maxima": int(ref.sum()), "low": int(r_low.sum()),
         "high": int(r_high.sum()), "rows": canny_nms_plan(n // (h * w), h, w, _cuda.sms(mag.device)),
         "fused_ms_turns": [turns[0], turns[3]], "unfused_ms_turns": [turns[1], turns[2]]})
    if not 0 < int(r_high.sum()) < int(r_low.sum()) < int(ref.sum()):
        raise AssertionError(f"K11's masks at {tuple(mag.shape)} do not exercise both thresholds")


def check_canny(chk: Checks, dev) -> None:
    """K11 at the evaluation's shape, one (1, 1024, 2048) Cityscapes frame:
    the Sobel gradients of a seeded random smooth map, in float64 (the
    evaluation's dtype: the masks must equal the plain version's) and in
    float32 (at most 1e-4 of the pixels may differ; logged, not recorded
    for the path), by ``check_k11``: the evaluation's form of the mask mode,
    over the eroded mask of a map with a hole, the thresholds the 60% and
    90% quantiles of the magnitude."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.evaluation.metrics import _gaussian_filter, _sobel

    g = torch.Generator(device=dev).manual_seed(4)
    x = _gaussian_filter(torch.randn((1024, 2048), generator=g, device=dev, dtype=torch.float64), 2.0)
    gi, gj = _sobel(x, 0).contiguous(), _sobel(x, 1).contiguous()
    maps64 = [t[None] for t in (gi, gj, torch.hypot(gi, gj))]
    lo, hi = (float(q) for q in torch.quantile(maps64[2].flatten()[::8], torch.tensor(
        [0.6, 0.9], dtype=torch.float64, device=dev)))
    mask = torch.ones((1, 1024, 2048), dtype=torch.float64, device=dev)
    mask[:, 300:500, 800:1200] = 0.0
    eroded = (1 - F.max_pool2d(1 - F.pad(mask, (1, 1, 1, 1))[None], 3, stride=1))[0] > 0
    for dt in (torch.float64, torch.float32):
        check_k11(chk, "cityscapes_eval", [t.to(dt).contiguous() for t in maps64], lo, hi, eroded,
                  main=dt == torch.float64)


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
    float64 and float32, each in the NMS mode and in the mask mode over the
    interior and over a random region (thresholds at magnitudes the maps
    hold). Then ``canny_boundary_cases``."""
    import torch

    from patchrefinerv2_torch.ops.canny import (
        canny_nms, canny_nms_masks, canny_nms_masks_plain, canny_nms_plain,
    )

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
        region = torch.rand(m[2].shape, generator=g, device=dev) < 0.8
        for dt in (torch.float64, torch.float32):
            m_dt = [t.to(dt).contiguous() for t in m]
            cases.append((f"canny_nms {name} {str(dt)[6:]}", canny_nms(*m_dt).float(),
                          canny_nms_plain(*m_dt).float()))
            for form, r in (("interior", None), ("region", region)):
                got = canny_nms_masks(*m_dt, 1.0, 1.5, r)
                ref = canny_nms_masks_plain(*m_dt, 1.0, 1.5, r)
                cases += [(f"canny_nms_masks {name} {form} {which} {str(dt)[6:]}", a.float(), b.float())
                          for which, a, b in zip(("low", "high"), got, ref)]
    canny_boundary_cases(dev, g)
    return cases


def canny_boundary_cases(dev, g) -> None:
    """K11 in both modes (the interior and a random region) with each row
    count R, on the vector path where the width allows it and on the scalar
    path, at batch 3, widths 1, 3, 127, 128, 129, 257, 512 and 513 and heights
    1, R - 1, R and R + 1 (normal gradients, thresholds 0.5 and 1.5), and
    through the wrappers on maps that start 4 or 8 bytes off a 16-byte
    boundary (the scalar path): float64 bit for bit, float32 at most 1e-4
    of all the pixels differing (the counts are logged)."""
    import torch

    from patchrefinerv2_torch.ops.canny import (
        NMS_ROWS, canny_nms, canny_nms_masks, canny_nms_masks_plain, canny_nms_plain, nms_launch,
        nms_vector_path,
    )

    differ = {torch.float64: 0, torch.float32: 0}
    pixels = {torch.float64: 0, torch.float32: 0}  # mask pixels compared
    launches = 0

    def compare(dt, got, ref):
        differ[dt] += sum(int((a != b).sum()) for a, b in zip(got, ref))
        pixels[dt] += sum(a.numel() for a in got)

    for rows in NMS_ROWS:
        for h in sorted({1, rows - 1, rows, rows + 1}):
            for w in (1, 3, 127, 128, 129, 257, 512, 513):
                m64 = [torch.randn((3, h, w), generator=g, device=dev, dtype=torch.float64) for _ in range(2)]
                m64.append(torch.hypot(*m64))
                region = torch.rand((3, h, w), generator=g, device=dev) < 0.8
                for dt in differ:
                    m = [t.to(dt).contiguous() for t in m64]
                    refs = ([canny_nms_plain(*m)], canny_nms_masks_plain(*m, 0.5, 1.5),
                            canny_nms_masks_plain(*m, 0.5, 1.5, region))
                    for vector in (True, False) if nms_vector_path(w, *m, region) else (False,):
                        compare(dt, [nms_launch(*m, rows=rows, vector=vector)], refs[0])
                        compare(dt, nms_launch(*m, True, 0.5, 1.5, rows=rows, vector=vector), refs[1])
                        compare(dt, nms_launch(*m, True, 0.5, 1.5, region, rows=rows, vector=vector), refs[2])
                        launches += 3
    for dt in differ:  # rows off a 16-byte boundary: the wrappers take the scalar path
        flat = torch.randn((2 * 3 * 40 * 512 + 1,), generator=g, device=dev, dtype=dt)
        gi, gj = flat[1:].view(2, 3, 40, 512)
        m = [gi, gj, torch.hypot(gi, gj)]
        if nms_vector_path(512, *m):
            raise AssertionError("an offset view should not take K11's vector path")
        compare(dt, [canny_nms(*m)], [canny_nms_plain(*m)])
        compare(dt, canny_nms_masks(*m, 0.5, 1.5), canny_nms_masks_plain(*m, 0.5, 1.5))
        launches += 2
    share = differ[torch.float32] / pixels[torch.float32]
    log({"check": "canny_nms boundary shapes", "launches": launches, "pixels_f64": pixels[torch.float64],
         "pixels_f32": pixels[torch.float32],
         "differ_f64": differ[torch.float64], "differ_f32": differ[torch.float32], "f32_share": share})
    if differ[torch.float64] or share > 1e-4:
        raise AssertionError(f"K11 disagrees with its plain version at the boundary shapes: {differ}")


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
    ("K12 hysteresis", ("hysteresis_resident_kernel", "hysteresis_tiled_kernel")),
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
    "K12 hysteresis": (("hysteresis_bounded",), False),
}


ENCODER_RANGE = "MobileNetV4 encoder"  # the profiler range around a MobileNetV4 refiner encoder
# depthwise convolution kernels by name; cuDNN ran MobileNetV4-small's 15 a
# chunk (bf16, channels_last) as ``conv2d_c1_k1_nhwc_specialized`` on the H100
DEPTHWISE = ("depthwise", "dwconv", "conv2d_c1_k1")


def range_share(prof, name: str) -> dict:
    """The device time of the kernels under the ``name`` ranges of a profile
    (a module's cuDNN convolutions, BatchNorms and the rest, inside the
    groups they fall in by name), the depthwise convolutions' part of it,
    and its costliest kernels."""
    import torch

    ranges = [e for e in prof.events()
              if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    kernels = {}

    def walk(ev):
        for k in getattr(ev, "kernels", ()):
            n, us = kernels.get(k.name, (0, 0.0))
            kernels[k.name] = (n + 1, us + k.duration)
        for c in ev.cpu_children:
            walk(c)

    for e in ranges:
        walk(e)
    total = sum(float(getattr(e, "device_time_total", 0.0) or 0.0) for e in ranges) / 1e3
    dw = sum(us for name, (_, us) in kernels.items() if any(k in name.lower() for k in DEPTHWISE))
    top = sorted(((us / 1e3, n, name[:90]) for name, (n, us) in kernels.items()), reverse=True)[:8]
    return {"calls": len(ranges), "device_ms": total, "depthwise_conv_ms": dw / 1e3,
            "top_kernels_ms_calls_name": top}


def profile_frame(fn, frame_ms: float, label: str, ranges=None) -> None:
    """One frame under torch.profiler: device time by layer, the costliest
    kernels, and the share of the unprofiled frame time the device spends
    in kernels. Every kernel of ``csrc/`` and of the Triton ops must fall in
    its own K group: each group's profiled launches are held against its
    wrappers' launch counters over the frame (``K_GROUP_WRAPPERS``), so a
    kernel whose name no longer matches its group's fragments fails the run
    instead of landing in another group. ``ranges`` ({name: module}): each
    module runs under a profiler range of its name while the frame is
    profiled, and its device time is reported apart (``range_share``; its
    kernels stay in their groups too), as the MobileNetV4 encoder's under
    ``ENCODER_RANGE``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from patchrefinerv2_torch import ops

    ranges = ranges or {}
    for name, module in ranges.items():
        def ranged(*a, _name=name, _forward=module.forward, **kw):
            with record_function(_name):
                return _forward(*a, **kw)

        module.forward = ranged
    ops.reset_launches()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for module in ranges.values():
            del module.forward
    counts = ops.launch_counts()
    groups, launches, total, kernels = {}, {}, 0.0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in ranges:
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
         "top_kernels_ms_calls_name": sorted(kernels, reverse=True)[:15],
         **{name.lower().replace(" ", "_"): range_share(prof, name) for name in ranges}})
    for grp, (_, exact) in K_GROUP_WRAPPERS.items():
        got = launches.get(grp, 0)
        if (exact and got != want[grp]) or (want[grp] > 0 and got == 0):
            raise AssertionError(f"{label}: the profile puts {got} kernel launches in {grp!r}, its wrappers "
                                 f"counted {want[grp]}: a kernel of the group is named outside its fragments")


# kernels that the frames do not run: canny belongs to the evaluation, K10
# to the int8 serving mode
FRAME_IDLE_OK = ("canny_nms", "hysteresis_bounded", "quant_conv")
INT8_IDLE_OK = ("canny_nms", "hysteresis_bounded")
QUANT_SITES_PER_CHUNK = sum(s[6] for s in quant_sites(32))  # 15
# the head's int8 sites, which K10 takes from K9 in the int8 runs
HEAD_INT8_SITES = sum(s[6] for s in quant_sites(32) if s[7] != "plain")  # 3


def check_tail_per_chunk(label, counts, per_chunk=9) -> None:
    """K9 runs once at each of its sites in every chunk (the flagship's 9, 6
    in an int8 run, where K10 takes the head's 3), and roi_align 7 times
    (the six coarse levels and the coarse depth): their counts must agree,
    chunk for chunk."""
    chunks = counts["roi_align"] / 7
    log({"phase": f"{label}_tail_conv_per_chunk", "chunks": chunks, "tail_conv": counts["tail_conv"],
         "per_chunk": per_chunk})
    if chunks < 1 or counts["tail_conv"] != per_chunk * chunks:
        raise AssertionError(f"{label}: {counts['tail_conv']} tail_conv launches for {chunks} chunks, "
                             f"not {per_chunk} a chunk")


def check_gate_per_chunk(label, counts, per_chunk=GATE_UNITS_PER_CHUNK) -> None:
    """K5 runs once at each GatedConvUnit of the fusion head with a fusion
    conv in every chunk (the flagship's 9 C2F units and the head's), in
    every run, int8 included: 10 a chunk (roi_align's 7 count the chunks);
    0 in the self-agg C2F and without C2F."""
    chunks = counts["roi_align"] / 7
    log({"phase": f"{label}_gate_tail_per_chunk", "chunks": chunks, "gate_tail": counts["gate_tail"],
         "per_chunk": per_chunk})
    if chunks < 1 or counts["gate_tail"] != per_chunk * chunks:
        raise AssertionError(f"{label}: {counts['gate_tail']} gate_tail launches for {chunks} chunks, "
                             f"not {per_chunk} a chunk")


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


def v1_calls(model) -> tuple[dict, dict]:
    """PatchRefiner V1's launches of K3/K4, K6, K8, K5 and K9 counted from
    its modules (``kernel_calls``): (a frame's, the coarse branch once; a
    chunk's, the fine depth network and FusionUnet once)."""
    net = model.net
    fine, head = net.refiner_fine_branch.kernel_calls(), net.refiner_fusion_model.kernel_calls()
    return net.coarse_branch.kernel_calls(), {k: fine.get(k, 0) + head.get(k, 0) for k in {*fine, *head}}


def check_v1_launches(label, counts, model, frames: int) -> None:
    """Each counted kernel of a V1 run (``v1_calls``) launched ``frames``
    times its frame count and once a chunk its chunk count (roi_align's 7 a
    chunk count the chunks), exactly."""
    per_frame, per_chunk = v1_calls(model)
    chunks = counts["roi_align"] / 7
    want = {k: frames * per_frame.get(k, 0) + chunks * per_chunk.get(k, 0)
            for k in sorted({*per_frame, *per_chunk})}
    got = {k: counts[k] for k in want}
    log({"phase": f"{label}_v1_launches", "frames": frames, "chunks": chunks, "launches": got,
         "per_frame": per_frame, "per_chunk": per_chunk})
    if chunks < 1 or got != want:
        raise AssertionError(f"{label}: launches {got} for {frames} frames and {chunks} chunks, "
                             f"not {want}")


def check_frame_launches(label, counts, model, frames: int, bins=(4, 1), int8_sites=0,
                         head_sites=HEAD_INT8_SITES) -> None:
    """K10 ``int8_sites`` times a chunk; for V1 ``check_v1_launches``;
    otherwise K5 and K9 as the head's ``kernel_calls`` says a chunk (K9
    ``head_sites`` fewer in an int8 run, where K10 takes them) and K8
    ``bins`` times a frame."""
    check_quant_per_chunk(label, counts, int8_sites)
    if model.v1:
        check_v1_launches(label, counts, model, frames)
        return
    per_chunk = model.net.refiner_fusion_model.kernel_calls()
    check_tail_per_chunk(label, counts, per_chunk["tail_conv"] - (head_sites if int8_sites else 0))
    check_gate_per_chunk(label, counts, per_chunk["gate_tail"])
    check_bins_per_frame(label, counts, frames, bins)


class Frames:
    """Runs one model's tiled inference on a fixed random 2160x3840 frame;
    ``bins``: its K8 launches a frame (``check_bins_per_frame``); ``per_chunk``:
    its fusion head's K5 and K9 launches a chunk, counted from its modules
    (``BiDirectionalFusion.kernel_calls``); a V1 model's launches are held
    to ``check_v1_launches``."""

    def __init__(self, model, lr_shape, dev, bins=(4, 1)):
        import torch

        g = torch.Generator().manual_seed(0)
        self.model, self.bins = model, bins
        self.per_chunk = model.net.refiner_fusion_model.kernel_calls()
        self.image_lr = torch.rand((1, *lr_shape, 3), generator=g).to(dev)
        self.image_hr = torch.rand((1, 2160, 3840, 3), generator=g).to(dev)

    def infer(self, mode):
        return self.model.infer(self.image_lr, self.image_hr, mode, process_num=16)

    def first(self, mode, label, idle_ok=FRAME_IDLE_OK, int8_sites=0, head_sites=HEAD_INT8_SITES):
        """The first frame of a mode, with the launch counters set to 0 just
        before it and read just after: every kernel but ``idle_ok`` must
        have launched, K10 ``int8_sites`` times a chunk, K5 and K9 as
        ``per_chunk`` says (the flagship's 10 and 9), K9 ``head_sites``
        fewer in an int8 run (K10 takes them). The map is the reensemble
        canvas for m1 and m2, the raw frame for rN."""
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
        check_frame_launches(label, counts, self.model, 1, self.bins, int8_sites, head_sites)
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
    """The model ``config`` names (``build_model``: PatchRefinerPlus or
    PatchRefiner V1), random weights from seed 0, on the card."""
    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.models.patchrefiner import build_model

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    t = time.time()
    model = build_model(cfg.model, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.net.parameters())
    log({"phase": f"{label}_build", "seconds": time.time() - t, "params": n_params})
    return model


def flagship(dev) -> dict:
    """The flagship's frames: each run's launch counts, and the warm m1
    bfloat16 frame's host ms (``m1_bfloat16_ms``), which ``data_run`` holds
    the benchmark's fps to."""
    import torch

    fr = Frames(build(dev, "configs/patchrefinerv2_zoedepth/v2_eff_u4k.py", "flagship"),
                (384, 512), dev)
    if fr.per_chunk != {"gate_tail": GATE_UNITS_PER_CHUNK, "tail_conv": len(tail_sites(32))}:
        raise AssertionError(f"the flagship's head counts {fr.per_chunk} kernel calls a chunk, its "
                             f"sites {GATE_UNITS_PER_CHUNK} and {len(tail_sites(32))}")
    d32, _ = fr.first("m1", "m1_float32_first")
    fr.timed("m1", "m1_float32_timed", 2)
    fr.model.set_infer_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    d16, counts_m1 = fr.first("m1", "m1_bfloat16_first")
    m1_ms = fr.timed("m1", "m1_bfloat16_timed", 5)
    profile_frame(lambda: fr.infer("m1"), m1_ms, "m1_bfloat16")
    torch.cuda.reset_peak_memory_stats()
    _, counts_m2 = fr.first("m2", "m2_bfloat16_first")
    m2_ms = fr.timed("m2", "m2_bfloat16_timed", 2)
    profile_frame(lambda: fr.infer("m2"), m2_ms, "m2_bfloat16")
    # r32: the m2 stream, then 2 random chunks of 16 on the raw canvas
    torch.cuda.reset_peak_memory_stats()
    _, counts_r32 = fr.first("r32", "r32_bfloat16_first")
    r32_ms = fr.timed("r32", "r32_bfloat16_timed", 2)
    profile_frame(lambda: fr.infer("r32"), r32_ms, "r32_bfloat16")
    rel = float(((d16.float() - d32).abs() / d32.abs().clamp(min=1e-6)).mean())
    log({"phase": "m1_bf16_vs_f32", "mean_rel_diff": rel, "note": "information only"})
    return dict(m1=counts_m1, m2=counts_m2, r32=counts_r32, **int8_frames(fr, "", d16, True),
                m1_bfloat16_ms=m1_ms)


def int8_frames(fr, label, d16, flagship: bool, idle_ok=INT8_IDLE_OK, ranges=None) -> dict:
    """The int8 serving mode on the frame, bfloat16. For the flagship first
    the dynamic mode (no calibration: ``set_int8(None, "dynamic")``), m1
    first, timed and profiled. Then calibrate on the frame (m1 and the three
    shifted passes, process_num 16; seconds and the sites the default gates
    select, which must be the 15 of the JAX default's site list), then with
    per-channel scales m1 (first, timed, profiled) and, for the flagship,
    r32 (the JAX bench's mode: first, timed, profiled) and an m1 first frame
    with per-tensor scales; K10 once a chunk at each selected site and K9
    at its sites but the selected head sites (15 and 6 on the flagship's
    head). The mean relative differences of the int8 m1 depths from the
    bfloat16 one are for information. ``ranges``: as ``profile_frame``
    takes them."""
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
    head = sum(cal.sites[n]["layout"] != "plain" for n in sel)
    model.set_int8(cal, "perchan")
    torch.cuda.reset_peak_memory_stats()
    d8, runs[f"{label}m1_int8"] = fr.first("m1", f"{label}m1_int8_perchan_first", idle_ok, len(sel), head)
    ms = fr.timed("m1", f"{label}m1_int8_perchan_timed", 5 if flagship else 3)
    profile_frame(lambda: fr.infer("m1"), ms, f"{label}m1_int8_perchan", ranges)
    rel = float(((d8.float() - d16.float()).abs() / d16.float().abs().clamp(min=1e-6)).mean())
    log({"phase": f"{label}m1_int8_vs_bf16", "mean_rel_diff": rel, "note": "information only"})
    if flagship:
        torch.cuda.reset_peak_memory_stats()
        _, runs["r32_int8"] = fr.first("r32", "r32_int8_perchan_first", idle_ok, len(sel), head)
        ms = fr.timed("r32", "r32_int8_perchan_timed", 2)
        profile_frame(lambda: fr.infer("r32"), ms, "r32_int8_perchan")
        model.set_int8(cal, "tensor")
        _, runs["m1_int8_tensor"] = fr.first("m1", "m1_int8_tensor_first", idle_ok, len(sel), head)
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


MOBILE_ENCODER = "mobilenetv4_conv_small.e2400_r224_in1k"
MOBILE_CONFIG = "configs/patchrefinerv2_zoedepth/v2_mobile_u4k.py"
# the fusion head's forms the MobileNetV4 ablations take, and the other two widths
MOBILE_VARIANTS = {
    "no_c2f": "configs/patchrefinerv2_zoedepth_ablation/plus_mobile_u4k_base_coarse.py",
    "self_agg": "configs/patchrefinerv2_zoedepth_ablation/plus_mobile_c2f_selfagg.py",
    "medium": "configs/patchrefinerv2_zoedepth_ablation/plus_mobile_mid_u4k_base_coarse_e2e_c2f.py",
    "large": "configs/patchrefinerv2_zoedepth_ablation/plus_mobile_large_u4k_base_coarse_e2e_c2f.py",
}


def check_mobile_shapes(model, label: str) -> None:
    """The kernels of a MobileNetV4 path meet the flagship's shapes, which
    the kernel phase holds them at: the process shape and the coarse
    levels (K1's rois, the head's widths) are the flagship's, C2F runs 256
    wide (K5's sites, K10's), and K9's level-0 fusion layers read parts the
    flagship's do: (coarse level 0, C2F's last_feat) or, without C2F,
    (coarse level 0, the refiner's full-resolution level)."""
    net = model.net
    head = net.refiner_fusion_model
    c0 = net.coarse_branch.coarse_chl[0]
    parts = (c0, head.fusion_layers_1[0].single_conv[0].in_channels - c0)
    c2f = None if head.c2f is None else head.c2f.scratch.layer1_rn.out_channels
    same = (tuple(net.patch_process_shape) == PATHS["flagship"]["process"]
            and list(net.coarse_branch.coarse_chl) == [c for *_, c in FLAGSHIP_LEVELS[:6]][::-1]
            and parts in [s[1] for s in tail_sites(32)] and c2f in (None, 256))
    log({"phase": f"{label}_kernel_shapes", "fusion1_0_parts": parts, "c2f_features": c2f,
         "per_chunk": head.kernel_calls(), "flagship_shapes": same})
    if not same:
        raise AssertionError(f"{label}: a kernel meets shapes the kernel phase does not check")


def mobile(dev) -> dict:
    """PatchRefinerV2-Mobile (``v2_mobile_u4k``: the flagship's BEiT-L
    ZoeDepth coarse branch, the MobileNetV4-small refiner, BiDirectionalFusion
    over [32, 32, 64, 96, 960]; random weights from seed 0) on the 2160x3840
    frame split 4x4, process_num 16: m1 in float32 (TF32 off), then m1, m2
    and r32 in bfloat16, each a first frame (launch counters checked chunk
    by chunk against the head's ``kernel_calls``) and timed warm frames,
    each bfloat16 mode profiled with the MobileNetV4 encoder's device time
    apart; then calibrated int8 m1 with per-channel scales (first, timed,
    profiled); then ``Tester.run`` m1 over two synthetic Cityscapes frames
    (``plus_mobile_cs_pretrain.py``)."""
    import torch

    model = build(dev, MOBILE_CONFIG, "mobile")
    check_mobile_shapes(model, "mobile")
    enc = {ENCODER_RANGE: model.net.refiner_fine_branch.refiner_encoder}
    fr = Frames(model, (384, 512), dev)
    torch.cuda.reset_peak_memory_stats()
    d32, _ = fr.first("m1", "mobile_m1_float32_first")
    fr.timed("m1", "mobile_m1_float32_timed", 2)
    model.set_infer_dtype(torch.bfloat16)
    runs = {}
    for mode, n in (("m1", 3), ("m2", 2), ("r32", 2)):
        torch.cuda.reset_peak_memory_stats()
        d, runs[f"mobile_{mode}"] = fr.first(mode, f"mobile_{mode}_bfloat16_first")
        if mode == "m1":
            d16 = d
        ms = fr.timed(mode, f"mobile_{mode}_bfloat16_timed", n)
        profile_frame(lambda: fr.infer(mode), ms, f"mobile_{mode}_bfloat16", enc)
    rel = float(((d16.float() - d32).abs() / d32.abs().clamp(min=1e-6)).mean())
    log({"phase": "mobile_m1_bf16_vs_f32", "mean_rel_diff": rel, "note": "information only"})
    runs.update(int8_frames(fr, "mobile_", d16, False, ranges=enc))
    del fr, model, enc, d16, d32
    torch.cuda.empty_cache()
    runs.update(cityscapes_eval(dev, "configs/patchrefinerv2_zoedepth_cs/plus_mobile_cs_pretrain.py",
                                ("m1",), "mobile_"))
    return runs


def mobile_variants(dev) -> dict:
    """The MobileNetV4 ablations, m1 in bfloat16 on the same frame: the
    fusion forms ``coarse2fine=False`` (no C2F: K9 4 times a chunk, K5
    never) and ``self-agg`` (K9 8 times, K5 never), and the medium and large
    refiners with the coarse-gated head; each a first frame with its
    counters, timed frames and a profiled frame."""
    import torch

    runs = {}
    for name, config in MOBILE_VARIANTS.items():
        label = f"mobile_{name}"
        model = build(dev, config, label)
        model.set_infer_dtype(torch.bfloat16)
        check_mobile_shapes(model, label)
        fr = Frames(model, (384, 512), dev)
        idle = FRAME_IDLE_OK + (("gate_tail",) if fr.per_chunk["gate_tail"] == 0 else ())
        torch.cuda.reset_peak_memory_stats()
        _, runs[f"{label}_m1"] = fr.first("m1", f"{label}_m1_bfloat16_first", idle)
        ms = fr.timed("m1", f"{label}_m1_bfloat16_timed", 3)
        profile_frame(lambda: fr.infer("m1"), ms, f"{label}_m1_bfloat16",
                      {ENCODER_RANGE: model.net.refiner_fine_branch.refiner_encoder})
        del fr, model
        torch.cuda.empty_cache()
    return runs


def v1_ranges(model) -> dict:
    """Profiler ranges around V1's fine depth network and FusionUnet."""
    net = model.net
    return {"V1 fine branch": net.refiner_fine_branch, "V1 fusion head": net.refiner_fusion_model}


def patchrefiner_v1(dev) -> dict:
    """PatchRefiner V1 at full width (``configs/patchrefiner_zoedepth/
    pr_u4k.py``: two BEiT-L/16 + ZoeDepth networks, the fine one run on
    every chunk, and FusionUnet; random weights from seed 0) on the
    2160x3840 frame split 4x4, process_num 16: m1 in float32 (TF32 off),
    then m1 and r32 in bfloat16 (r32 runs m1's and m2's passes first), each
    a first frame (every counted launch held to the modules'
    ``kernel_calls``, chunk by chunk: ``check_v1_launches``), timed warm
    frames with peak memory and, in bfloat16, a profiled frame with the fine
    branch's and FusionUnet's device time apart. Then the DA2 V1
    (``configs/patchrefiner_dav2/pr_u4k.py``: two DINOv2-L + DPT networks at
    448x448) m1 in bfloat16 alike."""
    import torch

    model = build(dev, V1_CONFIG, "v1")
    fr = Frames(model, model.patch_process_shape, dev)
    idle = FRAME_IDLE_OK + ("gate_tail",)
    torch.cuda.reset_peak_memory_stats()
    d32, _ = fr.first("m1", "v1_m1_float32_first", idle)
    fr.timed("m1", "v1_m1_float32_timed", 2)
    model.set_infer_dtype(torch.bfloat16)
    runs = {}
    for mode, n in (("m1", 3), ("r32", 2)):
        torch.cuda.reset_peak_memory_stats()
        d, runs[f"v1_{mode}"] = fr.first(mode, f"v1_{mode}_bfloat16_first", idle)
        if mode == "m1":
            d16 = d
        ms = fr.timed(mode, f"v1_{mode}_bfloat16_timed", n)
        profile_frame(lambda: fr.infer(mode), ms, f"v1_{mode}_bfloat16", ranges=v1_ranges(model))
    rel = float(((d16.float() - d32).abs() / d32.abs().clamp(min=1e-6)).mean())
    log({"phase": "v1_m1_bf16_vs_f32", "mean_rel_diff": rel, "note": "information only"})
    del fr, model, d, d16, d32
    torch.cuda.empty_cache()
    model = build(dev, V1_DA2_CONFIG, "v1_da2")
    model.set_infer_dtype(torch.bfloat16)
    fr = Frames(model, model.patch_process_shape, dev, bins=(0, 0))
    torch.cuda.reset_peak_memory_stats()
    _, runs["v1_da2_m1"] = fr.first("m1", "v1_da2_m1_bfloat16_first",
                                    idle + ("attractor_update", "log_binomial_depth"))
    ms = fr.timed("m1", "v1_da2_m1_bfloat16_timed", 3)
    profile_frame(lambda: fr.infer("m1"), ms, "v1_da2_m1_bfloat16", ranges=v1_ranges(model))
    del fr, model
    torch.cuda.empty_cache()
    return runs


# the small composed graphs' flagship topology: a tiny BEiT ZoeDepth coarse
# branch with the EfficientNet-B5 refiner and BiDirectionalFusion
TINY_REFINER = dict(fine_branch=dict(type="LightWeightRefiner", encoder_name="tf_efficientnet_b5_ap"))
TINY_ZOE = dict(
    image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
    fusion_feat_level=6, min_depth=1e-3, max_depth=80, strategy_refiner_target="offset_coarse",
    coarse_branch=dict(type="ZoeDepth", n_bins=16, bin_embedding_dim=16, attractor_kind="mean",
                       attractor_type="inv",
                       trunk=dict(embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3],
                                  features=32, out_channels=[24, 32, 48, 48])),
    refiner=dict(TINY_REFINER, fusion_model=dict(type="BiDirectionalFusion",
                                                 coarse_chl=[32, 16, 16, 16, 16, 32])))


# the tiny V1 topology: the tiny BEiT ZoeDepth as the coarse and the fine branch
TINY_V1 = dict(TINY_ZOE, refiner=dict(
    fine_branch=TINY_ZOE["coarse_branch"],
    fusion_model=dict(type="FusionUnet", temp_chl=[16, 32, 32, 32, 32, 32], dec_chl=[32, 32, 32, 32, 16])))


def small_gpu_vs_cpu(dev) -> None:
    """The composed graph at a small size, kernels on the card against the
    plain versions on the CPU, float32: a tiny BEiT ZoeDepth coarse branch
    (head dim 16) and a ``vitt`` DA2 one (head dim 48, bicubic position
    embedding), each with the EfficientNet-B5 refiner and BiDirectionalFusion
    (m1, m2, r8); the tiny ZoeDepth graph with the MobileNetV4-small
    refiner, the CPU tests' mobile slice (m1); and the tiny V1 (the tiny
    ZoeDepth as both branches, FusionUnet; m1)."""
    import numpy as np

    from patchrefinerv2_torch.models.patchrefiner import MODELS

    refiner, zoe = TINY_REFINER, TINY_ZOE
    da2 = dict(
        zoe, image_raw_shape=[112, 168], patch_process_shape=[56, 84],
        coarse_branch=dict(type="DA2", model_cfg=dict(encoder="vitt", features=64)),
        refiner=dict(refiner, fusion_model=dict(type="BiDirectionalFusion",
                                                coarse_chl=[32, 64, 64, 64, 64, 64])))
    mobile = dict(zoe, refiner=dict(zoe["refiner"], fine_branch=dict(TINY_REFINER["fine_branch"],
                                                                       encoder_name=MOBILE_ENCODER)))
    plus, v1 = MODELS["PatchRefinerPlus"], MODELS["PatchRefiner"]
    for name, cls, cfg, modes in (("zoedepth", plus, zoe, ("m1", "m2", "r8")),
                                  ("da2_vitt", plus, da2, ("m1", "m2", "r8")),
                                  ("mobile", plus, mobile, ("m1",)), ("v1", v1, TINY_V1, ("m1",))):
        gpu = cls(cfg, device=dev, seed=3)
        cpu = cls(cfg, device="cpu", seed=3)
        rng = np.random.RandomState(11)
        lr = rng.rand(1, *cfg["patch_process_shape"], 3).astype(np.float32)
        hr = rng.rand(1, *cfg["image_raw_shape"], 3).astype(np.float32)
        for mode in modes:
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

            from patchrefinerv2_torch.datasets.transforms import resize_hwc
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

    ds = Frames("infer", os.devnull, {}, min_depth=1e-3, max_depth=250)  # no split: no files
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


def cityscapes_eval(dev, config="configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_pretrain.py",
                    modes=("m1", "m2", "r32"), label="") -> dict:
    """``Tester.run`` at full width: ``plus_eff_cs_pretrain.py`` (the flagship
    network on 1024x2048 frames split 4x4 into 256x512 patches; or
    ``config``), bfloat16, random weights from seed 0, over 2 synthetic
    frames in each of ``modes`` with process_num 16. Each mode's launch
    counters are set to 0 just before its run and read just after: every
    kernel of the path and canny must have launched, K5 and K9 as the
    head's ``kernel_calls`` says a chunk. Every metric must be finite. With
    random weights the prediction is nearly flat: the count of its canny
    edge pixels per frame is printed (read after the counters), and
    ``eval_gpu_vs_cpu`` times ``get_metrics`` on a frame with edges."""
    import math

    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.datasets.base import DataLoader
    from patchrefinerv2_torch.evaluation.tester import Tester

    model = build(dev, config, f"{label}cs")
    model.set_infer_dtype(torch.bfloat16)
    gate_idle = model.net.refiner_fusion_model.kernel_calls()["gate_tail"] == 0
    idle_ok = ("quant_conv", "hysteresis_bounded") + (("gate_tail",) if gate_idle else ())
    counts = {}
    for mode in modes:
        ds = synthetic_cityscapes(2, model.patch_process_shape)
        timed = TimedModel(model)
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        metrics = Tester({}, timed, DataLoader(ds)).run(
            cai_mode=mode, process_num=16, image_raw_shape=(1024, 2048), patch_split_num=(4, 4))
        seconds = time.time() - t0
        counts[f"{label}eval_{mode}"] = c = ops.launch_counts()
        edges = [pred_edge_pixels(p, (1024, 2048)) for p in ds.preds]
        log({"phase": f"{label}cityscapes_eval_{mode}_bfloat16", "metrics": metrics, "seconds": seconds,
             "infer_ms_per_frame": timed.infer_ms, "metrics_ms_per_frame": ds.metric_ms,
             "pred_edge_pixels_per_frame": edges,
             "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": c})
        want = {"a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel", "see",
                "EdgeAcc", "EdgeComp", "precision", "recall", "f1"}
        if set(metrics) != want or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cityscapes eval {mode}: bad metrics {metrics}")
        idle = [k for k, v in c.items() if v == 0 and k not in idle_ok]
        if idle:
            raise AssertionError(f"cityscapes eval {mode}: kernels never launched: {idle}")
        check_frame_launches(f"{label}cityscapes_eval_{mode}", c, model, len(ds))
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
    ds = CityScapesDataset("infer", os.devnull, {}, min_depth=1e-3, max_depth=250)
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


# ------------------------------------------------------------------ training
PRETRAIN_CONFIG = "configs/patchrefinerv2_zoedepth/pretrain_eff_m0s1.py"
TRAIN_KERNELS = ("resize", "layer_norm", "gate_tail", "tail_conv")  # the pretraining step's
# the smoke run's training work dir (listed in .gitignore, removed after the run)
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_work")


def process_size(cfg) -> list:
    """The network process size of the config's train loader: 384x512, or
    DA2's 448x448."""
    return list(cfg.train_dataloader.dataset.get("transform_cfg", {}).get("network_process_size",
                                                                          [384, 512]))


def pretrain_config(batch: int = 4, steps: int = 3, patch=None, config: str = PRETRAIN_CONFIG):
    """The pretraining stage (``pretrain_eff_m0s1``, or ``config``: batch 4,
    384x512 images (DA2's 448x448), 2160x3840 depth, remat on) over
    ``steps`` batches of SyntheticDataset in one epoch; ``patch`` shrinks
    the image and depth sizes."""
    from patchrefinerv2_torch.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    ds = dict(type="SyntheticDataset", mode="train", length=batch * steps,
              network_process_size=process_size(cfg))
    if patch is not None:
        h, w = patch
        cfg.model.config.update(patch_process_shape=[h, w], image_raw_shape=[2 * h, 2 * w])
        ds.update(image_raw_shape=[2 * h, 2 * w], network_process_size=[h, w], patch_raw_shape=[h, w])
    cfg.merge_from_options({"train_dataloader.dataset": ds, "train_dataloader.batch_size": batch,
                            "val_dataloader": None, "train_cfg.max_epochs": 1,
                            "train_cfg.log_interval": 1, "train_cfg.save_checkpoint_interval": 1})
    cfg["seed"] = 0
    return cfg


STAGE3_CONFIG = "configs/patchrefinerv2_zoedepth/v2_eff_u4k.py"
# the coarse branch's kernels, which a stage-3 step launches as its
# ``kernel_calls`` says (K3 or K4 at each block; K8 at each attractor layer
# and once for the log-binomial, none in DA2)
COARSE_KERNELS = ("attention", "attractor_update", "log_binomial_depth")


def stage3_config(batch: int = 4, steps: int = 3, pretrained=None, val: bool = False,
                  config: str = STAGE3_CONFIG, options: dict | None = None):
    """Stage 3 (``v2_eff_u4k``, or ``config``: BEiT-L + ZoeDepth trained end
    to end, batch 4 of a 384x512 image (DA2's 448x448) and a 540x960 crop
    resized likewise against its depth, remat on) over ``steps`` batches of
    SyntheticDataset in one epoch, from the ``pretrained`` checkpoint;
    ``val``: one 2160x3840 m1 validation frame after the epoch, its image
    at the same size; ``options``: more overrides."""
    from patchrefinerv2_torch.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    process = process_size(cfg)
    cfg.merge_from_options({
        "train_dataloader.dataset": dict(type="SyntheticDataset", mode="train", length=batch * steps,
                                         network_process_size=process),
        "train_dataloader.batch_size": batch,
        "val_dataloader": dict(batch_size=1, dataset=dict(
            type="SyntheticDataset", mode="infer", length=1, network_process_size=process)) if val else None,
        "train_cfg.max_epochs": 1, "train_cfg.log_interval": 1,
        "train_cfg.save_checkpoint_interval": 1, "train_cfg.val_interval": 1,
        "model.config.pretrained": pretrained, **(options or {})})
    cfg["seed"] = 0
    return cfg


def make_trainer(dev, cfg, work_dir):
    """A Trainer of ``cfg`` (either stage) on the card, its validation
    loader when the config has one."""
    from patchrefinerv2_torch.datasets.base import DataLoader
    from patchrefinerv2_torch.models.patchrefiner import build_model
    from patchrefinerv2_torch.train import build_dataset
    from patchrefinerv2_torch.training.trainer import Trainer

    model = build_model(cfg.model, device=dev, seed=0)
    loader = DataLoader(build_dataset(cfg.train_dataloader.dataset),
                        batch_size=cfg.train_dataloader.batch_size, shuffle=True, seed=0)
    val = cfg.get("val_dataloader")
    val = DataLoader(build_dataset(val.dataset), batch_size=1) if val else None
    return Trainer(cfg, model, loader, val, work_dir=work_dir)


# each training Function: its kernel's name, module and class
TRAIN_FUNCTIONS = {"resize": ("resize", "_Resize"), "layer_norm": ("layer_norm", "_LayerNorm"),
                   "gate_tail": ("gated", "_GateTail"), "tail_conv": ("tail_conv", "_TailConv"),
                   "roi_align": ("roi_align", "_RoiAlign"), "attention": ("attention", "_Attention"),
                   "attractor_update": ("bins", "_Attractor"),
                   "log_binomial_depth": ("bins", "_LogBinomial")}


class SiteRecorder:
    """Records the arguments of every call of the training Functions (their
    ``apply``) while it is on: the training sites' shapes."""

    def __init__(self):
        import importlib

        self.mods = {k: importlib.import_module(f"patchrefinerv2_torch.ops.{m}")
                     for k, (m, _) in TRAIN_FUNCTIONS.items()}
        self.fns = {k: cls for k, (_, cls) in TRAIN_FUNCTIONS.items()}
        self.sites = {k: {} for k in self.fns}

    def __enter__(self):
        self.saved = {}
        for k, cls in self.fns.items():
            fn = getattr(self.mods[k], cls)
            self.saved[k] = fn.apply

            def rec(*args, _k=k, _apply=fn.apply):
                key = self.key(_k, args)
                self.sites[_k][key] = self.sites[_k].get(key, 0) + 1
                return _apply(*args)

            fn.apply = rec
        return self

    def __exit__(self, *exc):
        for k, cls in self.fns.items():
            getattr(self.mods[k], cls).apply = self.saved[k]

    @staticmethod
    def key(kind, args):
        """A hashable description of one call: shapes and flags."""
        shape = lambda t: None if t is None else tuple(t.shape)  # noqa: E731
        if kind == "resize":
            x, size, mode, ac, scale = args
            return (shape(x), tuple(size), mode, ac, None if scale is None else tuple(scale))
        if kind == "layer_norm":
            return (shape(args[0]),)
        if kind == "gate_tail":
            return (shape(args[0]), args[1] is not None)
        if kind == "roi_align":
            f, boxes, _, size, scale = args
            return (shape(f), boxes.shape[0], tuple(size), scale)
        if kind == "attention":
            q, _, _, table, scale, grid = args
            return (shape(q), shape(table), scale, None if grid is None else tuple(grid))
        if kind == "attractor_update":
            return (shape(args[0]), shape(args[1]), *args[2:])
        if kind == "log_binomial_depth":
            return (shape(args[0]), shape(args[1]), *args[2:])
        cfg, w, b, res, lw, _, *parts = args
        return (tuple(shape(p) for p in parts), shape(w), b is not None,
                None if res is None else ("x" if res is parts[0] else "map"), lw is not None, *cfg)


def _train_case(kind, key, dev, g):
    """(function of the tensors, plain function, tensors, indices of the
    parameters, library backward or None) of one recorded training site,
    with seeded float32 inputs. A K9 site whose epilogue ends in a ReLU
    (without LN) gets as its plain function the plain conv and epilogue
    without the ReLU, which the caller multiplies by the kernel output's
    mask: the kernel and the plain version sum in other orders, so a
    pre-activation within rounding of 0 can pass the ReLU on one side only,
    and the gradients are compared at the same activation pattern."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.gated import gate_tail, gate_tail_plain
    from patchrefinerv2_torch.ops.layer_norm import layer_norm, layer_norm_plain
    from patchrefinerv2_torch.ops.resize import resize, resize_plain
    from patchrefinerv2_torch.ops.tail_conv import tail_conv, tail_conv_plain

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=g, device=dev) * scale

    if kind == "resize":
        shp, size, mode, ac, scale = key
        x = randn(*shp)
        aten = {"bilinear": torch.ops.aten.upsample_bilinear2d_backward,
                "bicubic": torch.ops.aten.upsample_bicubic2d_backward}[mode]
        scales = (None, None) if scale is None else scale
        lib = lambda gy: aten(  # noqa: E731
            gy.permute(0, 3, 1, 2), list(size), [shp[0], shp[3], shp[1], shp[2]], ac, *scales)
        return (lambda t: resize(t, size, mode, ac, scale),
                lambda t: resize_plain(t, size, mode, ac, scale), [x], [], lib)
    if kind == "layer_norm":
        (shp,) = key
        c = shp[-1]
        ts = [randn(*shp, scale=2.0) + 0.3, torch.rand((c,), generator=g, device=dev) + 0.5,
              randn(c, scale=0.1)]
        xs = ts[0].reshape(-1, c)
        mean, rstd = xs.mean(-1), torch.rsqrt(xs.var(-1, unbiased=False) + 1e-6)
        lib = lambda gy: torch.ops.aten.native_layer_norm_backward(  # noqa: E731
            gy.reshape(-1, c), xs, [c], mean[:, None], rstd[:, None], ts[1], ts[2],
            [True, True, True])
        return layer_norm, layer_norm_plain, ts, [1, 2], lib
    if kind in ("roi_align", "attention", "attractor_update", "log_binomial_depth"):
        return _coarse_train_case(kind, key, dev, g)
    if kind == "gate_tail":
        shp, gate = key
        c = shp[-1]
        ts = [randn(*shp, scale=2.0) + 0.3, randn(*shp), randn(c, c, 1, 1, scale=c ** -0.5),
              torch.rand((c,), generator=g, device=dev) + 0.5, randn(c, scale=0.1)]
        o = (lambda t: t) if gate else (lambda t: None)
        return (lambda f, out, w, lw, lb: gate_tail(f, o(out), w, lw, lb),
                lambda f, out, w, lw, lb: gate_tail_plain(f, o(out), w, lw, lb), ts, [2, 3, 4], None)
    part_shapes, wshape, has_bias, res, has_ln, act, relu_in, eps = key
    cout, cin, k = wshape[0], wshape[1], wshape[-1]
    parts = [torch.rand(p, generator=g, device=dev) * 10 if p[-1] == 1 else randn(*p)
             for p in part_shapes]
    ts = [randn(*wshape, scale=(k * k * cin) ** -0.5), randn(cout, scale=0.1),
          torch.rand((*part_shapes[0][:3], cout), generator=g, device=dev) * 10,
          torch.rand((cout,), generator=g, device=dev) + 0.5, randn(cout, scale=0.1), *parts]

    def fn(impl, act=act):
        def run(w, b, r, lw, lb, *ps):
            resid = ps[0] if res == "x" else r if res == "map" else None
            return impl(list(ps), w, b if has_bias else None, resid, (lw, lb) if has_ln else None,
                        act=act, relu_in=relu_in, eps=eps)
        return run

    xin = torch.cat(parts, -1).permute(0, 3, 1, 2)
    lib = lambda gy: torch.ops.aten.convolution_backward(  # noqa: E731
        gy.permute(0, 3, 1, 2), xin, ts[0], None, [1, 1], [k // 2] * 2, [1, 1], False, [0, 0], 1,
        [True, True, False])
    params = [0] + ([1] if has_bias else []) + ([3, 4] if has_ln else [])
    masked = act == "relu" and not has_ln
    return fn(tail_conv), fn(tail_conv_plain, "none" if masked else act), ts, params, lib


def _coarse_train_case(kind, key, dev, g):
    """``_train_case`` of the Functions that only stage 3 trains: K1 (the
    crops' boxes of a stage-3 batch in the process frame, one an image),
    K3/K4, K8. Library backwards: ``F.grid_sample``'s (bilinear, border) for
    K1, as its forward row times it; ``F.scaled_dot_product_attention``'s
    with the bias as a float mask that takes a gradient for K3; K8 has
    none."""
    import torch
    import torch.nn.functional as F

    from patchrefinerv2_torch.ops.attention import attention, attention_plain, relative_position_bias
    from patchrefinerv2_torch.ops.bins import (
        attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
    )
    from patchrefinerv2_torch.ops.roi_align import roi_align, roi_align_plain

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=g, device=dev) * scale

    def rand(*s, scale=1.0):
        return torch.rand(s, generator=g, device=dev) * scale

    if kind == "roi_align":
        shp, n, size, scale = key
        # the process frame (the flagship's 384x512, DA2's 448x448): its
        # height is the level's over the scale, its width at the level's
        # aspect; crops of 540x960 in 2160x3840
        ph = round(shp[1] / scale)
        pw = round(ph * shp[2] / shp[1])
        bh, bw = ph * 540 / 2160, pw * 960 / 3840
        xy = rand(n, 2) * torch.tensor([pw - bw, ph - bh], device=dev)
        boxes = torch.cat([xy, xy + torch.tensor([bw, bh], device=dev)], 1)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        x = randn(*shp)
        grid = roi_grid(boxes, size, scale, shp[1:3])
        xs = x.detach().permute(0, 3, 1, 2)[idx.long()].requires_grad_(True)
        ys = F.grid_sample(xs, grid, mode="bilinear", padding_mode="border", align_corners=False)
        lib = lambda gy: torch.autograd.grad(ys, xs, gy.permute(0, 3, 1, 2),  # noqa: E731
                                             retain_graph=True)
        return (lambda t: roi_align(t, boxes, idx, size, scale),
                lambda t: roi_align_plain(t, boxes, idx, size, scale), [x], [], lib)
    if kind == "attention":
        shp, tshape, scale, grid = key
        ts = [randn(*shp) for _ in range(3)] + ([randn(*tshape, scale=0.5)] if tshape else [])
        lq = [t.detach().clone().requires_grad_(True) for t in ts[:3]]
        mask = None
        if tshape:
            mask = relative_position_bias(ts[3], grid)[None].detach().requires_grad_(True)
        ys = F.scaled_dot_product_attention(*lq, attn_mask=mask, scale=scale)
        lib = lambda gy: torch.autograd.grad(ys, lq + ([mask] if tshape else []), gy,  # noqa: E731
                                             retain_graph=True)
        if tshape:
            return (lambda q, k, v, t: attention(q, k, v, scale, t, grid),
                    lambda q, k, v, t: attention_plain(q, k, v, scale, t, grid), ts, [3], lib)
        return (lambda q, k, v: attention(q, k, v, scale), lambda q, k, v: attention_plain(q, k, v, scale),
                ts, [], lib)
    if kind == "attractor_update":
        ashape, bshape, *rest = key
        normed = rest[2]

        def one(fn):
            def run(a, b):
                out = fn(a, b, *rest)
                return torch.cat(out, -1) if normed else out[0]
            return run

        ts = [rand(*ashape, scale=3.0), rand(*bshape, scale=3.0)]
        return one(attractor_update), one(attractor_update_plain), ts, [], None
    pshape, cshape, *rest = key
    ts = [F.softplus(randn(*pshape, scale=2.0)), rand(*cshape, scale=20.0)]
    return (lambda p, c: log_binomial_depth(p, c, *rest),
            lambda p, c: log_binomial_depth_plain(p, c, *rest), ts, [], None)


def _backward_work(kind, key, ts) -> tuple[float, float]:
    """(bytes, operations) of a backward: its inputs (the saved tensors and
    the output gradient) read once, each gradient written once; operations
    of the gradients' products (the conv's data and weight gradients, the
    1x1's two products and its recomputed output, 4 a tap of a resize: a
    product and a sum along each axis)."""
    in_bytes = 4 * sum(t.numel() for t in ts)
    if kind == "resize":
        shp, size, mode = key[:3]
        out = shp[0] * size[0] * size[1] * shp[3]
        taps = 4 if mode == "bicubic" else 2  # a product and a sum a tap, along each axis
        return 4 * (out + shp[0] * shp[1] * shp[2] * shp[3]), 4.0 * taps * out
    if kind == "layer_norm":
        return 3 * 4 * ts[0].numel(), 12.0 * ts[0].numel()
    if kind == "gate_tail":
        rows, c = ts[0].numel() // ts[0].shape[-1], ts[0].shape[-1]
        return 2 * in_bytes, (6 if key[1] else 4) * rows * c * c + 30.0 * rows * c
    if kind == "roi_align":
        (b, h, w, c), n, (oh, ow), _ = key
        out = n * oh * ow * c
        return 4.0 * (out + b * h * w * c), 8.0 * out  # two taps an axis, a product and a sum each
    if kind == "attention":
        (b, nh, s, d), tshape = key[0], key[1]
        # read q, k, v, O, dO; write dq, dk, dv (and the table's gradient);
        # S recomputed, dv, dO v^T, dq, dk: five S x S x D products
        table = 8 * tshape[0] * tshape[1] if tshape else 0
        return 4.0 * 8 * b * nh * s * d + table, 10.0 * b * nh * s * s * d + 10.0 * b * nh * s * s
    if kind == "attractor_update":
        (b, h, w, na), (_, sh, sw, nb) = key[0], key[1]
        px = b * h * w
        # read a, b_new and the gradient, b_prev; write da, db_prev; per
        # (pixel, attractor, bin) the difference, dist' and the two sums
        return 4.0 * (2 * px * na + 2 * px * nb + 2 * b * sh * sw * nb), 14.0 * px * na * nb
    if kind == "log_binomial_depth":
        (b, h, w, _), (_, sh, sw, k) = key[0], key[1]
        px = b * h * w
        # read pt, the centres and the gradient; write dpt and dcentres; per
        # (pixel, bin) the logits, the softmax, its gradient and the resizes
        return 4.0 * (2 * 4 * px + px + 2 * b * sh * sw * k), 30.0 * px * k
    part_shapes, wshape = key[0], key[1]
    npx = part_shapes[0][0] * part_shapes[0][1] * part_shapes[0][2]
    k2cc = wshape[1] * wshape[0] * wshape[2] * wshape[3]
    recompute = 2 if key[4] or key[5] == "gelu" else 0
    return 2 * in_bytes, (4 + recompute) * npx * k2cc


def check_training_sites(chk: Checks, dev) -> dict:
    """Phase A: every site of the training Functions in one step of each
    full-width training stage (recorded from a step on the card): the
    pretraining stage (K2, K5, K6, K9; path ``train_backward``), stage 3
    (the same four at the coarse branch's widths and in BEiT and its DPT
    neck, and K1, K3 and K8; path ``train_e2e_backward``), V1 (K2, K3,
    K6, K8 in the fine ZoeDepth network, K2, K6 and K9 in FusionUnet; path
    ``train_v1_backward``) and BaselinePretrain's DA2 coarse step (K4 at
    (4, 16, 1025, 64), K6 in DINOv2-L, K2 in the DPT neck and the loss, and
    the bicubic K2 of the position embedding, (1, 37, 37, 1024) -> 32x32;
    path ``train_da2_backward``), each at its
    shapes in float32 (TF32 off): the Function's output and gradients
    against autograd through the plain version, and the times of the
    Function's backward, the plain version's autograd backward and, where
    one library call computes the gradient, that call
    (``upsample_bilinear2d_backward`` for K2, ``upsample_bicubic2d_backward``
    with the same scales for the bicubic K2, ``native_layer_norm_backward``
    for K6, ``convolution_backward`` of the concatenated input for K9,
    ``F.grid_sample``'s backward for K1, ``scaled_dot_product_attention``'s
    with a float mask for K3 and without for K4; K5 and K8 have none). The
    DA2 stage-3 and DA2 V1 steps' sites (paths ``train_da2_e2e_backward``:
    K1 at the DA2 levels up to (448, 448, 128), K5 and K9 at its 448x448
    sites, K2, K4 and K6 in DINOv2-L and its DPT head; and
    ``train_v1_da2_backward``: K4 on the fine crops, FusionUnet's 128-wide K9
    sites) are recorded in ``da2_train_run``'s runs of those models and
    checked by ``check_sites`` alike. Tolerances: the output
    and the input gradients 1e-5 of the plain version's magnitude, the
    parameter gradients (and K3's table) 1e-4 of it (sums over up to 802,816
    pixels in another order). Each site's times count once for each of its
    backwards in a step. Returns each stage's sites with those counts."""
    import torch

    stages = (("train_backward", lambda: pretrain_config(steps=1)),
              ("train_e2e_backward", lambda: stage3_config(steps=1)),
              ("train_v1_backward", lambda: stage3_config(steps=1, config=V1_CONFIG)),
              ("train_da2_backward", lambda: baseline_config(BASELINE_DA2_CONFIG, steps=1)))
    out = {}
    for path, config in stages:
        with SiteRecorder() as rec:
            tr = make_trainer(dev, config(), os.path.join(WORK_DIR, "sites"))
            tr.model.train()
            tr.model.net.remat = False  # one forward call a backward: the counts are a step's backwards
            batch = tr.device_batch(next(iter(tr.train_loader)))
            tr.train_step(batch)
            torch.cuda.synchronize()
        del tr, batch
        torch.cuda.empty_cache()
        out[path] = rec.sites
        check_sites(chk, dev, path, rec.sites)
    return out


def check_sites(chk: Checks, dev, path: str, sites: dict) -> None:
    import torch

    g = torch.Generator(device=dev).manual_seed(13)
    for kind, kind_sites in sites.items():
        for key, calls in kind_sites.items():
            fn, plain, ts, params, lib = _train_case(kind, key, dev, g)
            ts = [t.requires_grad_(True) for t in ts]
            y, yp = fn(*ts), plain(*ts)
            if kind == "tail_conv" and key[-3] == "relu" and not key[4]:
                yp = yp * (y.detach() > 0)  # the kernel's ReLU mask (``_train_case``)
            gy = torch.randn(y.shape, generator=g, device=dev)
            got = torch.autograd.grad(y, ts, gy, retain_graph=True, allow_unused=True)
            ref = torch.autograd.grad(yp, ts, gy, retain_graph=True, allow_unused=True)
            rel = {"out": err_of(y, yp) / max(float(yp.abs().max()), 1e-30)}
            for i, r in enumerate(ref):
                if r is not None:
                    rel[i] = err_of(got[i], r) / max(float(r.abs().max()), 1e-30)
            over = {i: e for i, e in rel.items() if e > (1e-4 if i in params else 1e-5)}
            if over:
                raise AssertionError(f"training {kind} {key}: relative errors over the bars {over}")
            ms = time_ms(lambda: torch.autograd.grad(y, ts, gy, retain_graph=True, allow_unused=True))
            plain_ms = time_ms(lambda: torch.autograd.grad(yp, ts, gy, retain_graph=True,
                                                           allow_unused=True))
            lib_ms = time_ms(lambda: lib(gy)) if lib is not None else None
            nbytes, ops = _backward_work(kind, key, ts)
            # the record's error is relative (to each gradient's magnitude):
            # the sites' gradients differ in magnitude by orders
            chk.add(kind, path, torch.float32, max(rel.values()), 1e-4, calls * ms,
                    calls * plain_ms, None if lib_ms is None else calls * lib_ms, calls * nbytes,
                    calls * ops, in_sum=False)
            log({"training_site": kind, "path": path, "key": [str(k) for k in key],
                 "backwards_in_step": calls, "rel_err": {str(k): v for k, v in rel.items()},
                 "backward_ms": ms, "plain_backward_ms": plain_ms, "library_backward_ms": lib_ms})
            del fn, plain, ts, y, yp, gy, got, ref, lib
    torch.cuda.empty_cache()


class PlainCalls:
    """Counts the calls of the training kernels' plain versions while it is
    on (through their modules' globals, which the wrappers call)."""

    NAMES = (("resize", "resize_plain"), ("layer_norm", "layer_norm_plain"),
             ("gated", "gate_tail_plain"), ("tail_conv", "tail_conv_plain"),
             ("roi_align", "roi_align_plain"), ("attention", "attention_plain"),
             ("bins", "attractor_update_plain"), ("bins", "log_binomial_depth_plain"))

    def __enter__(self):
        import importlib

        self.count, self.saved = 0, []
        for mod, name in self.NAMES:
            m = importlib.import_module(f"patchrefinerv2_torch.ops.{mod}")
            orig = getattr(m, name)
            self.saved.append((m, name, orig))

            def counted(*a, _orig=orig, **kw):
                self.count += 1
                return _orig(*a, **kw)

            setattr(m, name, counted)
        return self

    def __exit__(self, *exc):
        for m, name, orig in self.saved:
            setattr(m, name, orig)


TRAIN_GROUPS = tuple(f"{cls}Backward" for _, cls in TRAIN_FUNCTIONS.values())


def profile_train_step(tr, batch, step_ms: float, label: str = "pretrain") -> None:
    """One step (loss and backward; the optimizer timed apart with CUDA
    events) under torch.profiler: device ms by group (the forward kernels by
    their K groups; cuDNN forward, data and weight gradients; BatchNorm;
    elementwise and the rest) and each training Function's backward (the
    device time under its autograd node), the optimizer's ms, and the busy
    share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr.model.train()

    def fwd_bwd():
        for p in tr.model.net.parameters():
            p.grad = None
        loss, _ = tr.model.loss(batch, generator=tr.generator, update_stats=True)
        loss["total_loss"].backward()

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    groups, total, by_fn, kernels = {}, 0.0, {}, []
    conv_kinds = (("dgrad", "conv dgrad"), ("wgrad", "conv wgrad"))
    for e in prof.key_averages():
        name = e.key
        if e.device_type != torch.autograd.DeviceType.CUDA:
            for fn_name in TRAIN_GROUPS:
                if fn_name in name:
                    by_fn[fn_name] = by_fn.get(fn_name, 0.0) + float(
                        getattr(e, "device_time_total", 0.0) or 0.0) / 1e3
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        low = name.lower()
        group = next((lbl for frag, lbl in conv_kinds if frag in low), None) or next(
            (g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        if group == "convolution":
            group = "conv forward"
        groups[group] = groups.get(group, 0.0) + us / 1e3
        total += us / 1e3
        kernels.append((us / 1e3, e.count, name[:90]))
    opt_ms = time_ms(lambda: tr.optimizer.step(), iters=3, warmup=1)
    log({"phase": f"{label}_step_profile", "device_ms_loss_and_backward": total, "optimizer_ms": opt_ms,
         "step_ms": step_ms, "device_busy_share": (total + opt_ms) / step_ms,
         "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
         "function_backward_device_ms": by_fn,
         "top_kernels_ms_calls_name": sorted(kernels, reverse=True)[:15]})


PRETRAINED = os.path.join(WORK_DIR, "pretrain", "checkpoint_01")  # the pretraining run's
MOBILE_PRETRAIN_CONFIG = "configs/patchrefinerv2_zoedepth_ablation/pretrain_mobile_m0s1.py"
MOBILE_PRETRAINED = os.path.join(WORK_DIR, "mobile_pretrain", "checkpoint_01")


def pretrain_run(dev, config: str = PRETRAIN_CONFIG, label: str = "pretrain",
                 checkpoint: str = PRETRAINED, timing: bool = True) -> dict:
    """Phase B: the pretraining stage (``config``) at full width through
    ``Trainer.run`` (3 steps of batch 4: 384x512 images, 2160x3840 depth,
    float32, TF32 off, remat on), the launch counters set to 0 just before
    each step and read just after: K2, K5, K6 and K9 launch in every step,
    no other kernel and no plain version runs; losses and gradients finite,
    the parameters and the BatchNorm statistics move. Then, with one batch
    on the card: ms a step over 2 steps, images/s, peak memory with remat on
    and off (1 step), and one profiled step (without ``timing``: the peak
    memory of the run). Returns the first step's launch counts. Its
    checkpoint stays for stage 3 (``checkpoint``)."""
    import torch

    tr = make_trainer(dev, pretrain_config(config=config), os.path.dirname(checkpoint))
    log({"phase": f"{label}_build", "params": sum(p.numel() for p in tr.model.net.parameters()),
         "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "tf32_cudnn": torch.backends.cudnn.allow_tf32, "remat": tr.model.net.remat})
    torch.cuda.reset_peak_memory_stats()
    steps = run_counted(tr, label, TRAIN_KERNELS)
    if timing:
        batch = tr.device_batch(next(iter(tr.train_loader)))
        times = step_times(tr, batch, label)
        tr.model.net.remat = True
        profile_train_step(tr, batch, times[True][0]["ms_per_step"], label)
        del batch
    else:
        log({"phase": f"{label}_peak_memory", "peak_bytes": torch.cuda.max_memory_allocated()})
    del tr
    torch.cuda.empty_cache()
    return steps[0]


def count_step(step, model, batch, label: str, kernels, exact, steps: list, times=None,
               losses_out=None) -> dict:
    """``step(batch)``, one training step of ``model``, with the launch
    counters set to 0 just before it and read just after: each kernel of
    ``kernels`` launches (``exact``: that many times), no other kernel and
    no plain version runs, losses and gradients are finite. The counts are
    appended to ``steps``, the step's ms to ``times`` and its losses to
    ``losses_out``."""
    import torch

    from patchrefinerv2_torch import ops

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with PlainCalls() as plain:
        out = step(batch)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    ms = (time.time() - t0) * 1e3
    if times is not None:
        times.append(ms)
    losses = {k: float(v) for k, v in out.items()}
    if losses_out is not None:
        losses_out.append(losses)
    finite = all(math.isfinite(v) for v in losses.values())
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.net.parameters()
                       if p.grad is not None)
    steps.append(counts)
    log({"phase": f"{label}_step_{len(steps)}", "ms": ms, "losses": losses,
         "grads_finite": grads_finite, "plain_calls": plain.count, "launches": counts})
    idle = [k for k in kernels if counts[k] == 0]
    other = {k: v for k, v in counts.items() if k not in kernels and v}
    wrong = {k: counts[k] for k, n in (exact or {}).items() if counts[k] != n}
    if idle or other or wrong or plain.count or not grads_finite or not finite:
        raise AssertionError(f"{label} step {len(steps)}: idle {idle}, other kernels {other}, "
                             f"counts off {wrong}, {plain.count} plain calls, finite grads "
                             f"{grads_finite}, losses {losses}")
    return out


def record_first_step(tr) -> list:
    """Make ``tr``'s first step record the training sites it runs
    (``SiteRecorder``), with remat off for that step only, so that a site's
    calls are its backwards in the step, and the peak memory counted from
    the step after it. Returns the list that receives the sites."""
    import torch

    step, recorded = tr.train_step, []

    def recording(batch):
        if recorded:
            return step(batch)
        remat, tr.model.net.remat = tr.model.net.remat, False
        try:
            with SiteRecorder() as rec:
                out = step(batch)
        finally:
            tr.model.net.remat = remat
        recorded.append(rec.sites)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return out

    tr.train_step = recording
    return recorded


def run_counted(tr, label: str, kernels, exact=None, moves=("bn_buffers", "params"), still=(),
                epoch_only: bool = False, times=None, save: bool = True) -> list:
    """``tr.run()`` (``epoch_only``: ``tr.train_epoch``, no checkpoint) with
    the launch counters set to 0 just before each step and read just after
    it: each kernel of ``kernels`` launches in every step (``exact``: that
    many times), no other kernel and no plain version runs; losses and
    gradients finite; then what ``moves`` names (the parameters, the
    BatchNorm statistics, the coarse branch's parameters) must have moved,
    what ``still`` names must not have, and (unless ``epoch_only``, or
    ``save`` is off: a checkpoint no later phase reads, 5-8 GB with the
    optimizer's state, is not written) a checkpoint be written. Returns
    each step's counts; each step's ms is appended to ``times``."""
    import torch

    before = {k: v.detach().clone() for k, v in tr.model.net.state_dict().items()}
    steps, step = [], tr.train_step
    tr.train_step = lambda batch: count_step(step, tr.model, batch, label, kernels, exact, steps, times)
    if not save:
        tr.save = lambda epoch: log({"phase": f"{label}_checkpoint", "written": False, "epoch": epoch})
    t0 = time.time()
    tr.train_epoch(tr.start_epoch) if epoch_only else tr.run()
    log({"phase": f"{label}_trainer_run", "seconds": time.time() - t0, "steps": tr.step})
    del tr.train_step
    if not save:
        del tr.save
    after = tr.model.net.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    moved = dict(bn_buffers=sum("running_" in k for k in changed),
                 params=sum(k in dict(tr.model.net.named_parameters()) for k in changed),
                 coarse_params=sum(k.startswith("coarse_branch.") for k in changed))
    log({"phase": f"{label}_moved", **moved, "of": len(before)})
    if not all(moved[k] for k in moves) or any(moved[k] for k in still) or \
            not (epoch_only or not save or os.path.exists(os.path.join(tr.work_dir, "checkpoint_01"))):
        raise AssertionError(f"{label} moved {moved} or wrote no checkpoint")
    return steps


def step_times(tr, batch, label: str, batch_size: int = 4) -> dict:
    """ms a step (host clock, the batch on the card, ended by a
    synchronise), images/s and peak memory, with remat on (2 steps) and
    off (1 step), each after a warm step."""
    import torch

    tr.model.train()  # the validation after the epoch leaves eval mode
    times = {}
    for remat, n in ((True, 2), (False, 1)):
        tr.model.net.remat = remat
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        for _ in range(n):
            tr.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3 / n
        times.setdefault(remat, []).append(dict(ms_per_step=ms, images_per_s=batch_size * 1e3 / ms,
                                                peak_bytes=torch.cuda.max_memory_allocated()))
    log({"phase": f"{label}_step_timing", "batch": batch_size, "remat_on": times[True],
         "remat_off": times[False]})
    return times


def stage3_run(dev, config: str = STAGE3_CONFIG, label: str = "stage3",
               pretrained: str = PRETRAINED, val: bool = True, timing: bool = True,
               sites=None) -> dict:
    """Phase D: stage 3 (``v2_eff_u4k``, or ``config``) at full width
    through ``Trainer.run``, from the pretraining run's checkpoint
    (``pretrained``; the merged and kept tensor counts are printed): 3
    steps of batch 4 (384x512 images and crops, 540x960 crop depths,
    float32, TF32 off, remat on; no checkpoint written), the launch counters
    set to 0 before each step and read after it: K1 7 times and the coarse branch's K3 or K4 and
    K8 as its ``kernel_calls`` says (24, 4 + 1 for BEiT-L ZoeDepth; 24, none
    for DA2) exactly, K2, K5, K6 and K9 in every step, no other kernel and
    no plain version; losses and
    gradients finite, the coarse branch, the other parameters and the
    BatchNorm statistics move; then (``val``) the default m1 validation of
    one 2160x3840 frame in float32 on the trained model (timed, its metrics
    finite). Then, with one batch on the card: ms a step, images/s and peak
    memory with remat on and off, and one profiled step (without
    ``timing``: the peak memory of the steps after the first). ``sites``
    ((Checks, path)): the first step's training sites are recorded
    (``record_first_step``: that step without remat) and checked there
    (``check_sites``). Returns the first step's counts."""
    import torch

    tr = make_trainer(dev, stage3_config(pretrained=pretrained, val=val, config=config),
                      os.path.join(WORK_DIR, label))
    log({"phase": f"{label}_build", "params": sum(p.numel() for p in tr.model.net.parameters()),
         "pretrained": tr.pretrained_report, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "tf32_cudnn": torch.backends.cudnn.allow_tf32, "remat": tr.model.net.remat,
         "e2e_training": tr.model.net.e2e_training})
    report = tr.pretrained_report.get("pretrained", {})
    if not report.get("taken") or not report.get("kept"):
        raise AssertionError(f"{label} took no tensor of the pretraining checkpoint: {report}")
    val_epoch, val = tr.val_epoch, {}

    def timed_val():
        torch.cuda.synchronize()
        t0 = time.time()
        val.update(val_epoch())
        torch.cuda.synchronize()
        val["ms"] = (time.time() - t0) * 1e3
        return val

    tr.val_epoch = timed_val
    torch.cuda.reset_peak_memory_stats()
    calls = tr.model.net.coarse_branch.kernel_calls()
    exact = {"roi_align": 7, **{k: calls[k] for k in COARSE_KERNELS}}
    kernels = TRAIN_KERNELS + ("roi_align",) + tuple(k for k in COARSE_KERNELS if calls[k])
    recorded = record_first_step(tr) if sites is not None else None
    steps = run_counted(tr, label, kernels, exact, ("bn_buffers", "params", "coarse_params"), save=False)
    peak = torch.cuda.max_memory_allocated()
    if sites is not None:  # run_counted has put the class's train_step back
        check_sites(sites[0], dev, sites[1], recorded[0])
    del tr.val_epoch
    if tr.val_loader is not None:
        log({"phase": f"{label}_val_m1_float32", **val})
        if not val or not all(math.isfinite(v) for v in val.values()):
            raise AssertionError(f"{label}'s m1 validation frame gave {val}")
    if timing:
        batch = tr.device_batch(next(iter(tr.train_loader)))
        times = step_times(tr, batch, label)
        tr.model.net.remat = True
        profile_train_step(tr, batch, times[True][0]["ms_per_step"], label)
        del batch
    else:
        log({"phase": f"{label}_peak_memory", "peak_bytes": peak})
    del tr
    torch.cuda.empty_cache()
    return steps[0]


def compare_train_steps(label: str, got: tuple, ref: tuple) -> None:
    """A step on the card (``got``) against the CPU (``ref``), each (loss,
    gradients, running statistics): loss max rel <= 1e-5, the whole
    gradient within 2e-2 of its norm (the CPU tests' float32 bars: at test
    sizes the step's gradient is ill-conditioned,
    tests/test_torch_train_slice.py) and each BatchNorm statistic within
    1e-4 of its leaf's largest value, a running mean's leaf scale floored
    at the largest running standard deviation."""
    import torch

    (lg, gg, sg), (lc, gc, sc) = got, ref
    d = float(torch.sqrt(sum(((gg[k] - gc[k]) ** 2).sum() for k in gc)))
    n = float(torch.sqrt(sum((gc[k] ** 2).sum() for k in gc)))

    # a running mean is measured in the activations' spread: with zero-mean
    # inputs (a BatchNorm's output with bias 0 before a 1x1 conv) it is 0 but
    # for rounding, ~1e-7
    def scale(k):
        if k.endswith("running_mean"):
            return max(float(sc[k].abs().max()), float(sc[k[:-4] + "var"].sqrt().max()))
        return float(sc[k].abs().max())

    bn_rel = {k: float((sg[k] - sc[k]).abs().max()) / scale(k) for k in sc}
    worst = max(bn_rel, key=bn_rel.get) if bn_rel else None  # V1 has no BatchNorm
    bn = bn_rel[worst] if bn_rel else 0.0
    i = int((sg[worst] - sc[worst]).abs().argmax()) if bn_rel else 0
    log({"phase": label, "loss_rel": abs(lg - lc) / abs(lc), "grad_rel": d / n,
         "bn_rel_of_leaf_max": bn, "bars": [1e-5, 2e-2, 1e-4], "grad_leaves": len(gc),
         "bn_worst": worst and [worst, float(sg[worst][i]), float(sc[worst][i]),
                                float(sc[worst].abs().max())],
         "bn_leaves_over_bar": sorted(k for k, v in bn_rel.items() if v > 1e-4)[:12]})
    if not (abs(lg - lc) <= 1e-5 * abs(lc) and d <= 2e-2 * n and bn <= 1e-4 and set(gg) == set(gc)):
        raise AssertionError(f"{label}: the step on the card disagrees with the CPU")


def _step_result(m, loss_dict) -> tuple:
    loss_dict["total_loss"].backward()
    return (float(loss_dict["total_loss"].detach()),
            {k: p.grad.detach().double().cpu() for k, p in m.net.named_parameters()
             if p.grad is not None},
            {k: v.double().cpu() for k, v in m.net.state_dict().items() if "running_" in k})


def tiny_train_gpu_vs_cpu(dev, config: str = PRETRAIN_CONFIG, label: str = "tiny_train") -> None:
    """Phase C: one pretraining step (``config``) of 48x64 patches (batch 2)
    on the card against the CPU from the same weights, batch and hacked
    features, within ``compare_train_steps``' bars."""
    import numpy as np
    import torch

    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    cfg = pretrain_config(batch=2, steps=1, patch=(48, 64), config=config).model.config
    rng = np.random.RandomState(5)
    batch = dict(image_lr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 depth_gt=(1.0 + 20.0 * rng.rand(2, 96, 128, 1)).astype(np.float32))
    out = []
    for d in (dev, "cpu"):
        m = PatchRefinerPlus(cfg, device=d, seed=3).train()
        with torch.no_grad():
            feats, _ = m.net.refiner_fine_branch(torch.zeros((2, 3, 48, 64), device=d))
        g = torch.Generator().manual_seed(9)
        cf = [torch.randn((2, f.shape[2], f.shape[3], c), generator=g).to(d).permute(0, 3, 1, 2)
              for f, c in zip(feats, m.net.hack_chl)]
        out.append(_step_result(m, m.loss(batch, update_stats=True, coarse_features=cf)[0]))
    compare_train_steps(f"{label}_gpu_vs_cpu", *out)


def tiny_stage3_gpu_vs_cpu(dev) -> None:
    """Phase E: one stage-3 step of the tiny flagship topology (a 4-block
    BEiT with head dim 16, the ZoeDepth head with 16 bins, the EfficientNet-B5
    refiner and BiDirectionalFusion; 48x64 patches, batch 2, remat on) on
    the card (K1, K3, K8 and the rest) against the CPU (the plain versions),
    from the same weights and batch, within ``compare_train_steps``' bars."""
    import numpy as np

    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    cfg = dict(TINY_ZOE, e2e_training=True, remat=True)
    rng = np.random.RandomState(5)
    batch = dict(image_lr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 crops_image_hr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 crop_depths=(1.0 + 20.0 * rng.rand(2, 72, 96, 1)).astype(np.float32),
                 bboxs=np.array([[0.0, 0.0, 32.0, 24.0], [16.0, 16.0, 48.0, 40.0]], np.float32))
    out = []
    for d in (dev, "cpu"):
        m = PatchRefinerPlus(cfg, device=d, seed=3).train()
        out.append(_step_result(m, m.loss(batch, update_stats=True)[0]))
    compare_train_steps("tiny_stage3_gpu_vs_cpu", *out)


def tiny_v1_train_gpu_vs_cpu(dev) -> None:
    """One V1 step of the tiny V1 topology (``TINY_V1``: 48x64 patches,
    batch 2) on the card (K3, K8, K9 and the rest; the coarse branch under
    no gradient) against the CPU, from the same weights and batch, within
    ``compare_train_steps``' bars (V1 has no BatchNorm statistics)."""
    import numpy as np

    from patchrefinerv2_torch.models.patchrefiner import PatchRefiner

    rng = np.random.RandomState(5)
    batch = dict(image_lr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 crops_image_hr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 crop_depths=(1.0 + 20.0 * rng.rand(2, 72, 96, 1)).astype(np.float32),
                 bboxs=np.array([[0.0, 0.0, 32.0, 24.0], [16.0, 16.0, 48.0, 40.0]], np.float32))
    out = []
    for d in (dev, "cpu"):
        m = PatchRefiner(TINY_V1, device=d, seed=3).train()
        out.append(_step_result(m, m.loss(batch, update_stats=True)[0]))
    compare_train_steps("tiny_v1_train_gpu_vs_cpu", *out)


V1_TRAIN_KERNELS = ("resize", "layer_norm", "tail_conv", "roi_align", "attention", "attractor_update",
                    "log_binomial_depth")


def v1_train_run(dev, config: str = V1_CONFIG, label: str = "v1_train", stage1: str | None = None,
                 timing: bool = True, sites=None) -> dict:
    """V1's training (``configs/patchrefiner_zoedepth/pr_u4k.py``, or
    ``config``) at full width through ``Trainer.run``, from random weights
    or (``stage1``) with a stage-1 checkpoint as both its
    ``pretrain_coarse_model`` and its ``pretrain_fine_model`` (the tensors
    each took printed; every tensor of the checkpoint taken by each): 3
    steps of batch 4 (384x512 images and crops, DA2's 448x448, 540x960 crop
    depths, float32, TF32 off, remat off as configured), the launch
    counters set to 0 before each step and read after it: K1 7 times and
    K3 or K4, K6, K8 and K9 as the modules' ``kernel_calls`` give a frame
    (the coarse branch, forward only) and a chunk (the fine network and
    FusionUnet), no other kernel and no plain version; losses and gradients
    finite; the fine network and the head move, the coarse branch does not
    (with ``stage1``: it is the checkpoint's network still); no checkpoint
    written. ``sites`` ((Checks, path)): the first step's training sites
    are recorded (``record_first_step``) and checked there
    (``check_sites``). Then ms a
    step, images/s and peak memory with remat on and off, and one profiled
    step (without ``timing``: the peak memory of the run). Returns the
    first step's counts."""
    import torch

    from patchrefinerv2_torch.utils.checkpoint import load_checkpoint

    options = {"model.config.pretrain_coarse_model": stage1, "model.config.pretrain_fine_model": stage1}
    tr = make_trainer(dev, stage3_config(config=config, options=options if stage1 else None),
                      os.path.join(WORK_DIR, label))
    log({"phase": f"{label}_build", "params": sum(p.numel() for p in tr.model.net.parameters()),
         "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "tf32_cudnn": torch.backends.cudnn.allow_tf32, "remat": tr.model.net.remat,
         "e2e_training": tr.model.net.e2e_training, "pretrained": tr.pretrained_report})
    if stage1:
        n = len(load_checkpoint(stage1)["state_dict"])
        taken = {k: tr.pretrained_report.get(k, {}).get("taken")
                 for k in ("pretrain_coarse_model", "pretrain_fine_model")}
        if any(t != n for t in taken.values()):
            raise AssertionError(f"{label} took {taken} of the stage-1 checkpoint's {n} tensors")
    per_frame, per_chunk = v1_calls(tr.model)
    calls = {k: per_frame.get(k, 0) + per_chunk.get(k, 0) for k in V1_TRAIN_KERNELS
             if k not in ("resize", "roi_align")}
    kernels = ("resize", "roi_align") + tuple(k for k, v in calls.items() if v)
    torch.cuda.reset_peak_memory_stats()
    recorded = record_first_step(tr) if sites is not None else None
    steps = run_counted(tr, label, kernels, {"roi_align": 7, **calls}, ("params",), ("coarse_params",),
                        save=False)
    peak = torch.cuda.max_memory_allocated()
    if sites is not None:  # run_counted has put the class's train_step back
        check_sites(sites[0], dev, sites[1], recorded[0])
    if stage1:
        own = tr.model.net.state_dict()
        off = [k for k, v in load_checkpoint(stage1)["state_dict"].items()
               if not torch.equal(own[k], v.to(dev))]
        log({"phase": f"{label}_coarse_branch_is_stage1", "unequal": off[:8]})
        if off:
            raise AssertionError(f"{label}: the frozen coarse branch left the stage-1 network: {off[:8]}")
    if timing:
        batch = tr.device_batch(next(iter(tr.train_loader)))
        times = step_times(tr, batch, label)
        tr.model.net.remat = False
        profile_train_step(tr, batch, times[False][0]["ms_per_step"], label)
        del batch
    else:
        log({"phase": f"{label}_peak_memory", "peak_bytes": peak})
    del tr
    torch.cuda.empty_cache()
    return steps[0]


# the Semi training path's loss shape: the ranking loss's canny over the
# pseudo labels of a batch of 4 at the 384x512 process size
SEMI_LOSS_SHAPE = (4, 384, 512)


def semi_depth(dev, shape=SEMI_LOSS_SHAPE, seed: int = 6):
    """A seeded (B, H, W) depth batch with ramps and a step in each map, a
    little noise on top: a pseudo label with canny edges."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, w = shape
    yy = torch.linspace(0, 1, h, device=dev)[:, None]
    xx = torch.linspace(0, 1, w, device=dev)[None, :]
    return 2.0 + 10.0 * torch.rand((b, 1, 1), generator=g, device=dev) * (yy + xx) \
        + 4.0 * (xx > torch.rand((b, 1, 1), generator=g, device=dev)) \
        + 0.5 * torch.rand(shape, generator=g, device=dev)


def semi_canny_maps(dev, shape=SEMI_LOSS_SHAPE, seed: int = 6):
    """``canny_masks`` of the loss (the float32 gradients and the low and
    high masks) for the log of ``semi_depth``'s batch."""
    import torch

    from patchrefinerv2_torch.models.losses_extra import canny_masks

    return canny_masks(torch.log(semi_depth(dev, shape, seed)))


def check_semi_kernels(chk: Checks, dev) -> None:
    """K11 in float32 and K12 at the Semi loss's (4, 384, 512), each on the
    canny of a seeded log-depth batch: K11 in both modes by ``check_k11``
    (the loss's form of the mask mode: the interior, thresholds 0.1 and
    0.2; at most 1e-4 of the pixels may differ from the plain version's),
    K12 bit for bit (the error is the share of pixels that differ). K12's
    bound counts 3 bytes a pixel (two masks read, one written). Then K12 on
    the three masks of ``hysteresis_masks`` and its edge cases."""
    import torch

    from patchrefinerv2_torch.ops.canny import hysteresis_bounded_plain

    maps, low, high = semi_canny_maps(dev)
    n = low.numel()
    check_k11(chk, "semi", maps, 0.1, 0.2)
    ref = hysteresis_bounded_plain(low, high)
    log({"check": "semi canny masks", "low": int(low.sum()), "high": int(high.sum()),
         "grown": int(ref.sum()), "of": n})
    if not 0 < int(high.sum()) < int(ref.sum()) < int(low.sum()):
        raise AssertionError("the Semi canny masks do not exercise the hysteresis")
    times = {name: check_hysteresis_mask(name, lo, hi, dev)
             for name, (lo, hi) in hysteresis_masks(low, high, dev).items()}
    canny = times.pop("canny")
    chk.add("hysteresis_bounded", "semi", torch.float32, canny["differ_share"], 0.0, canny["ms"],
            canny["plain_ms"], None, 3 * n, 0,
            extra={"exit_step": canny["exit_step"], "tiled_ms": canny["tiled_ms"],
                   "latency_floor_ms": canny["floor_ms"],
                   **{f"{name}_{k}": t[k] for name, t in times.items()
                      for k in ("ms", "exit_step", "tiled_ms")}})
    hysteresis_one_event(low, high)
    hysteresis_edge_cases(dev)


def ranking_loss_on_edges(dev) -> None:
    """The Semi ranking loss at full size on a pseudo label with edges:
    ``EdgeguidedRankingLoss`` as ``SEMI_CONFIGS["semi_ranking"]`` configures
    it (10000 point pairs), float32 at (4, 384, 512), the pseudo label
    ``semi_depth``'s batch and the prediction a seeded perturbation of it.
    The samples are drawn once on the CPU (from the CPU's edges) and given
    to both sides. The loss on the card must be within 1e-5 of the CPU's
    (relative), its canny must find edge pixels, and one call must launch
    K11 and K12 once each; the edge pixels and the call's device ms are
    logged."""
    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.models.losses import build_loss

    here = os.path.dirname(os.path.abspath(__file__))
    loss = build_loss(Config.fromfile(os.path.join(here, SEMI_CONFIGS["semi_ranking"])).model.edgeloss)
    depth = semi_depth(dev)
    g = torch.Generator(device=dev).manual_seed(8)
    pred = (depth * (1.0 + 0.05 * torch.randn(depth.shape, generator=g, device=dev)))[..., None]
    target = depth[..., None]
    cpu = (pred.cpu(), target.cpu())
    maps = loss.maps(*cpu)
    samples = loss.sample(maps[2], maps[4], torch.Generator().manual_seed(7))
    ref, ref_count = (float(v) for v in loss(*cpu, samples=samples))
    on_card = {k: v.to(dev) for k, v in samples.items()}
    torch.cuda.synchronize()
    ops.reset_launches()
    got, count = loss(pred, target, samples=on_card)
    got, count = float(got), float(count)
    counts = ops.launch_counts()
    edges = int(loss.maps(pred, target)[2].sum())
    ms = time_ms(lambda: loss(pred, target, samples=on_card))
    log({"phase": "semi_ranking_loss_on_edges", "shape": list(depth.shape), "point_pairs": loss.point_pairs,
         "loss": got, "loss_cpu": ref, "rel_err": abs(got - ref) / abs(ref), "samples": count,
         "samples_cpu": ref_count, "edge_pixels": edges, "edge_pixels_cpu": int(maps[2].sum()),
         "k11": counts["canny_nms"], "k12": counts["hysteresis_bounded"], "device_ms": ms})
    if not (abs(got - ref) <= 1e-5 * abs(ref) and ref > 0 and edges > 0):
        raise AssertionError(f"the ranking loss on the card ({got}, {edges} edge pixels) disagrees with "
                             f"the CPU's ({ref})")
    if counts["canny_nms"] != 1 or counts["hysteresis_bounded"] != 1:
        raise AssertionError(f"a ranking loss call launched K11 {counts['canny_nms']} and K12 "
                             f"{counts['hysteresis_bounded']} times, not once each")


def hysteresis_masks(low, high, dev) -> dict:
    """K12's masks at the Semi loss's (4, 384, 512): the canny masks of
    ``semi_canny_maps`` (weak chains a few pixels long: the loop leaves
    early), a snake across each plane (one-pixel runs joined at alternate
    ends, ~48 000 pixels long from one high pixel: every one of the 128
    steps changes it) and a dense random low mask (60%) with a sparse high
    one (0.1% of it)."""
    import torch

    b, h, w = low.shape
    g = torch.Generator(device=dev).manual_seed(13)
    dense = torch.rand(low.shape, generator=g, device=dev) < 0.6
    sparse = dense & (torch.rand(low.shape, generator=g, device=dev) < 0.001)
    snake_low, snake_high = hysteresis_snake(h, w, dev)
    return {"canny": (low, high), "snake": (snake_low.expand(b, h, w).contiguous(),
                                            snake_high.expand(b, h, w).contiguous()),
            "dense": (dense, sparse)}


def check_hysteresis_mask(name: str, low, high, dev) -> dict:
    """K12 with the wrapper's plan, with each cluster size (the CTAs that
    share a plane's reads and writes) and by the tiled kernel, bit for bit
    against the plain version, each resident launch's exit steps equal to
    the plain loop's (the first step that changes nothing); device ms of
    each and of the plain version. The latency floor
    (``hysteresis_latency_floor``): the plan's CTA running the 128 barrier
    steps of its loop and no work; and the floor of steps shared by a
    cluster of 2, 4 or 8 CTAs (their cluster barrier and flags a step)."""
    import torch

    from patchrefinerv2_torch.ops.canny import (
        RESIDENT_CLUSTERS, hysteresis_bounded, hysteresis_bounded_plain, hysteresis_exit_steps_plain,
        hysteresis_latency_floor, hysteresis_launch, hysteresis_plan,
    )

    b, h, w = low.shape
    ref, want = hysteresis_bounded_plain(low, high), hysteresis_exit_steps_plain(low, high)
    out = {"plain_ms": time_ms(lambda: hysteresis_bounded_plain(low, high), iters=3, warmup=1)}
    plans = {f"cluster_{c}": hysteresis_plan(h, w, c) for c in RESIDENT_CLUSTERS}
    plans["tiled"] = None
    for label, plan in plans.items():
        exits = None if plan is None else torch.full((b,), -1, dtype=torch.int32, device=dev)
        got = hysteresis_launch(low, high, 128, plan, exits)
        differ = int((got != ref).sum())
        if differ or (exits is not None and not torch.equal(exits, want)):
            raise AssertionError(f"hysteresis_bounded {name} {label}: {differ} pixels differ from the "
                                 f"plain version, exit steps {exits} against {want.tolist()}")
        out[f"{label}_ms"] = time_ms(lambda: hysteresis_launch(low, high, 128, plan))
    plan = hysteresis_plan(h, w)
    for c in RESIDENT_CLUSTERS:
        out["floor_ms" if c == 1 else f"cluster_{c}_floor_ms"] = time_ms(
            lambda: hysteresis_latency_floor(b, 128, plan._replace(cluster=c), dev))
    got = hysteresis_bounded(low, high)
    out.update(ms=time_ms(lambda: hysteresis_bounded(low, high)), exit_step=int(want.max()),
               differ_share=float((got != ref).double().mean()))
    log({"check": f"hysteresis_bounded {name}", "shape": [b, h, w], "plan": plan._asdict(),
         "exit_steps": want.tolist(), "grown": int(ref.sum()), "low": int(low.sum()),
         "high": int(high.sum()), **out})
    if out["differ_share"]:
        raise AssertionError(f"hysteresis_bounded {name} disagrees with its plain version")
    if name == "snake" and not (want == 128).all():
        raise AssertionError("the snake did not run all 128 steps")
    return out


def hysteresis_one_event(low, high) -> None:
    """A resident call of K12 is one kernel on the card (torch.profiler),
    and the (1, 1024, 2048) plane's tiled call ceil(128 / 32) = 4."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from patchrefinerv2_torch.ops.canny import hysteresis_bounded

    big = torch.zeros((1, 1024, 2048), dtype=torch.bool, device=low.device)
    events = {}
    for label, (lo, hi), want in (("resident", (low, high), 1), ("tiled", (big, big), 4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hysteresis_bounded(lo, hi)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        events[label] = names
        if len(names) != want or not all(f"hysteresis_{label}_kernel" in k for k in names):
            raise AssertionError(f"a {label} K12 call made the kernel events {names}, not {want}")
    log({"check": "hysteresis_bounded kernel events a call", **events})


def hysteresis_snake(h: int, w: int, dev):
    """A one-pixel-wide snake (horizontal runs joined at alternate ends,
    longer than 128 pixels) as the low mask, its head as the high one."""
    import torch

    low = torch.zeros((1, h, w), dtype=torch.bool, device=dev)
    for i, r in enumerate(range(2, h - 2, 4)):
        low[0, r, 2:w - 2] = True
        if r + 4 < h - 2:
            low[0, r:r + 5, w - 3 if i % 2 == 0 else 2] = True
    high = torch.zeros_like(low)
    high[0, 2, 2] = True
    return low, high


def hysteresis_edge_cases(dev) -> None:
    """K12 against its plain version, bit for bit, by the wrapper's plan and
    by the tiled kernel: maps 1 pixel high and wide, sizes that are not
    multiples of the tiled kernel's 64x128 tile, batch 1, an empty high
    mask, a snake longer than 128 pixels (which it must not reach the end
    of), 1, 45 and 128 steps, planes either side of the resident threshold
    (1024 and 1025 pixels wide; 384 and 385 rows at 1024) and the
    evaluation's (1, 1024, 2048); the resident launches' exit steps equal to
    the plain loop's."""
    import torch

    from patchrefinerv2_torch.ops.canny import (
        hysteresis_bounded_plain, hysteresis_exit_steps_plain, hysteresis_launch, hysteresis_plan,
    )

    g = torch.Generator(device=dev).manual_seed(12)

    def rand(shape, p):
        return torch.rand(shape, generator=g, device=dev) < p

    cases = {}
    for name, shape, steps in (("1xW", (2, 1, 700), 128), ("Hx1", (2, 300, 1), 128),
                               ("odd 97x301", (3, 97, 301), 128), ("B=1 65x129", (1, 65, 129), 45),
                               ("1024 wide", (2, 64, 1024), 128), ("1025 wide", (2, 64, 1025), 128),
                               ("384x1024", (2, 384, 1024), 128), ("385x1024", (2, 385, 1024), 45),
                               ("1024x2048", (1, 1024, 2048), 128)):
        low = rand(shape, 0.6)
        cases[name] = (low, low & rand(shape, 0.03), steps)
    low = rand((2, 70, 200), 0.6)
    cases["empty high"] = (low, torch.zeros_like(low), 128)
    cases["snake"] = (*hysteresis_snake(96, 300, dev), 128)
    cases["45 steps"] = (low, low & rand(low.shape, 0.02), 45)
    cases["1 step"] = (low, low & rand(low.shape, 0.02), 1)
    for name, (low, high, steps) in cases.items():
        ref = hysteresis_bounded_plain(low, high, steps)
        want = hysteresis_exit_steps_plain(low, high, steps)
        plan = hysteresis_plan(*low.shape[-2:])
        for label, p in ((("resident", plan),) if plan else ()) + (("tiled", None),):
            exits = None if p is None else torch.full((low.shape[0],), -1, dtype=torch.int32, device=dev)
            got = hysteresis_launch(low, high, steps, p, exits)
            err = int((got != ref).sum())
            log({"check": f"hysteresis_bounded {name}", "path": label, "shape": list(low.shape),
                 "steps": steps, "plan": p._asdict() if p else None, "grown": int(ref.sum()),
                 "exit_steps": None if exits is None else exits.tolist(), "differ": err, "ok": err == 0})
            if err or (exits is not None and not torch.equal(exits, want)):
                raise AssertionError(f"hysteresis_bounded {name} ({label}): {err} pixels differ from the "
                                     f"plain version, exit steps {exits} against {want.tolist()}")
        if name.endswith(("1025 wide", "385x1024", "1024x2048")) == (plan is not None):
            raise AssertionError(f"hysteresis_bounded {name}: plan {plan} on the wrong side of the threshold")
        if name == "snake" and not steps < int(ref.sum()) < int(low.sum()):
            raise AssertionError("hysteresis_bounded reached the end of the snake")
        if name == "empty high" and (ref.any() or want.any()):
            raise AssertionError("hysteresis_bounded grew an empty high mask")


SEMI_CONFIGS = {  # label -> config of the Semi training phase
    "semi_ranking": "configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_semi_online_ranking_ft.py",
    "semi_ssigm": "configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_semi_online_ssigm_ft.py",
    "semi_v1_ranking": "configs/patchrefiner_zoedepth_online_pesudo/pr_ranking_cs.py",
}


def semi_config(config: str, batch: int = 4, steps: int = 3):
    """A Semi config over ``steps`` batches of SyntheticDataset frames of the
    Cityscapes geometry (1024x2048 frames, 256x512 raw patches resized to
    384x512), one epoch, no validation."""
    from patchrefinerv2_torch.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    cfg.merge_from_options({
        "train_dataloader.dataset": dict(type="SyntheticDataset", mode="train", length=batch * steps,
                                         image_raw_shape=[1024, 2048], patch_raw_shape=[256, 512],
                                         network_process_size=[384, 512]),
        "train_dataloader.batch_size": batch, "val_dataloader": None, "train_cfg.max_epochs": 1,
        "train_cfg.log_interval": 1})
    cfg["seed"] = 0
    return cfg


def semi_exact(model, ranking: bool) -> dict:
    """The launches a Semi step makes of the kernels that launch a fixed
    number of times: the student's and (online) the teacher's forward each
    run K1 7 times and the modules' ``kernel_calls`` (a frame and a chunk)
    of K8 (none for a DA2 coarse branch; and, V1, K3, K6 and K9); the
    ranking loss one K11 and one K12."""
    coarse = model.student.net.coarse_branch.kernel_calls()
    per = {"roi_align": 7, **{k: coarse[k] for k in ("attractor_update", "log_binomial_depth")}}
    if model.student.v1:
        per_frame, per_chunk = v1_calls(model.student)
        per.update({k: per_frame.get(k, 0) + per_chunk.get(k, 0) for k in V1_TRAIN_KERNELS
                    if k not in ("resize", "roi_align")})
    forwards = 2 if model.teacher is not None else 1
    out = {k: forwards * v for k, v in per.items()}
    out.update(canny_nms=int(ranking), hysteresis_bounded=int(ranking))
    return out


def semi_run(dev, label: str, config: str) -> dict:
    """The Semi transfer stage (``config``: an online teacher of the
    student's kind) at full width through ``Trainer``: 2 steps of batch 4
    (384x512 images and crops, 256x512 crop depths, float32, TF32 off), the
    launch counters set to 0 before each step and read after it: the
    student's and the teacher's kernels in every step, those of
    ``semi_exact`` exactly, no other kernel and no plain version; losses
    and gradients finite; the student's parameters (and BatchNorm
    statistics) move. Then the JAX optimizer's behaviour under Semi: every
    teacher parameter decayed by AdamW's ``lr * wd`` alone, step by step
    (replayed from its value before the run with the optimizer's own
    operations: equal within an ulp); ms a step (the second step), peak
    memory, K11 and K12 launches a step. Returns the first step's counts."""
    import torch

    tr = make_trainer(dev, semi_config(config, steps=2), os.path.join(WORK_DIR, label))
    model = tr.model
    ranking = model.edgeloss_type == "EdgeguidedRankingLoss"
    teacher0 = {k: p.detach().clone() for k, p in model.net.teacher.named_parameters()}
    log({"phase": f"{label}_build", "config": config,
         "student_params": sum(p.numel() for p in model.net.student.parameters()),
         "teacher_params": sum(p.numel() for p in model.net.teacher.parameters()),
         "edge_loss": model.edgeloss_type, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "tf32_cudnn": torch.backends.cudnn.allow_tf32, "student_remat": model.student.net.remat})
    exact = semi_exact(model, ranking)
    kernels = {k for k, v in exact.items() if v} | {"resize", "layer_norm", "attention", "tail_conv"}
    if not model.student.v1:
        kernels.add("gate_tail")
    torch.cuda.reset_peak_memory_stats()
    t0, ms = time.time(), []
    steps = run_counted(tr, label, sorted(kernels), exact,
                        ("params",) if model.student.v1 else ("bn_buffers", "params"),
                        epoch_only=True, times=ms)
    peak = torch.cuda.max_memory_allocated()
    lr = [float(tr.lr_schedule(i)) for i in range(tr.step)]
    wd = tr.optimizer.wd
    worst, leaves = 0.0, 0
    for k, p in model.net.teacher.named_parameters():
        want = [teacher0[k]]
        for r in lr:  # AdamW's update with zero moments: u = p * wd * -lr * 1, p + u
            torch._foreach_add_(want, torch._foreach_mul(torch._foreach_mul(
                torch._foreach_mul(want, wd), -r), 1.0))
        ulp = torch.finfo(torch.float32).eps * want[0].abs().clamp_min(1e-30)
        worst = max(worst, float(((p.detach() - want[0]).abs() / ulp).max()))
        leaves += 1
    log({"phase": f"{label}_teacher_decay", "leaves": leaves, "lr": lr, "weight_decay": wd,
         "worst_error_in_ulp": worst})
    if worst > 1.0:
        raise AssertionError(f"{label}: the teacher did not decay by lr * wd alone ({worst} ulp)")
    warm = ms[1:]  # the first step warms the allocator and cuDNN
    log({"phase": f"{label}_steps", "batch": 4, "ms_per_step": sum(warm) / len(warm), "ms": ms,
         "images_per_s": 4e3 * len(warm) / sum(warm), "peak_gb": peak / 1e9,
         "k11_per_step": steps[0]["canny_nms"], "k12_per_step": steps[0]["hysteresis_bounded"],
         "seconds": time.time() - t0})
    del tr, model, teacher0
    torch.cuda.empty_cache()
    return steps[0]


def tiny_semi_gpu_vs_cpu(dev) -> None:
    """One Semi step of the tiny flagship topology as the student with the
    ranking loss (500 point pairs; the samples drawn once on the CPU and
    moved to the card) on the card against the CPU, within
    ``compare_train_steps``' bars and the edge loss within 1e-5: online (a
    tiny teacher of random weights, whose flat pseudo label has no edge) and
    offline on a pseudo label with steps, whose edges the loss samples; and
    the student's m1 ``infer`` on both."""
    import numpy as np
    import torch

    from patchrefinerv2_torch.models.patchrefiner_semi import PatchRefinerSemi

    student = dict(type="PatchRefinerPlus", config=TINY_ZOE)
    rng = np.random.RandomState(5)
    batch = dict(image_lr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 crops_image_hr=rng.rand(2, 48, 64, 3).astype(np.float32),
                 crop_depths=(1.0 + 20.0 * rng.rand(2, 72, 96, 1)).astype(np.float32),
                 bboxs=np.array([[0.0, 0.0, 32.0, 24.0], [16.0, 16.0, 48.0, 40.0]], np.float32))
    xx = np.linspace(0, 1, 64)[None, None, :, None]
    pseudo = 2.0 + 6.0 * xx + 5.0 * (xx > np.array([0.3, 0.6])[:, None, None, None]) \
        + 0.05 * rng.rand(2, 48, 64, 1)
    lr, hr = rng.rand(1, 48, 64, 3).astype(np.float32), rng.rand(1, 96, 128, 3).astype(np.float32)
    for online in (True, False):
        cfg = dict(type="PatchRefinerSemi", model_cfg_student=student,
                   model_cfg_teacher=student if online else None,
                   edgeloss=dict(type="EdgeguidedRankingLoss", point_pairs=500), edge_loss_weight=1.0)
        b = batch if online else dict(batch, pseudo_label=pseudo.astype(np.float32))
        samples, out, depth = None, [], []
        for d in ("cpu", dev):
            m = PatchRefinerSemi(cfg, device=d, seed=3).train()
            if samples is None:
                with torch.no_grad():
                    _, aux = m.loss(b)
                    maps = m.edgeloss.maps(aux["depth_pred"], aux["pseudo_label"],
                                           torch.as_tensor(b["crop_depths"]))
                samples = m.edgeloss.sample(maps[2], maps[4], torch.Generator().manual_seed(7))
            ld, _ = m.loss(b, update_stats=True, edge_samples={k: v.to(d) for k, v in samples.items()})
            out.append((_step_result(m, ld), float(ld["edge_loss"].detach())))
            m.eval()
            depth.append(m.infer(lr, hr, "m1", process_num=4)[0].cpu())
        (ref, edge_c), (got, edge_g) = out
        err = float((depth[1] - depth[0]).abs().max()) / float(depth[0].abs().max())
        label = f"tiny_semi_{'online' if online else 'offline'}"
        log({"phase": f"{label}_edge_loss", "gpu": edge_g, "cpu": edge_c,
             "edge_anchors": int(samples["any_edge"].sum()), "infer_m1_err_over_max": err})
        compare_train_steps(f"{label}_gpu_vs_cpu", got, ref)
        if not (abs(edge_g - edge_c) <= 1e-5 * abs(edge_c) and err <= 1e-4) or \
                (not online and not (edge_c > 0 and samples["any_edge"].all())):
            raise AssertionError(f"{label}: the edge loss or the student's m1 on the card disagrees")


DATA_DIR = os.path.join(WORK_DIR, "data")  # the data phase's files (removed with WORK_DIR)
CS_PRETRAIN_CONFIG = "configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_pretrain.py"
CS_OFFLINE_CONFIG = "configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_semi_offline_ssigm_ft.py"


# the kernels of an offline Semi step of the flagship student (no teacher)
SEMI_STUDENT_KERNELS = ("resize", "layer_norm", "attention", "tail_conv", "gate_tail", "roi_align",
                        "attractor_update", "log_binomial_depth")


def write_u4k(root: str, frames: int) -> dict:
    """UnrealStereo4K files at full size, made with a seeded numpy RNG: for
    each frame a raw 2160x3840x3 uint8 BGR blob, a float32 disparity in
    (1, 64) (constant 240x240 blocks plus a ramp and noise, so that the
    boundary has edges) and the Extrinsics0/1 files (focal 1000, base 0.2);
    a train split of every frame, a val split of the first two, splits of
    the first one and the first four, and a split that lists every frame
    three times (six batches of 4). Returns their paths."""
    import numpy as np

    rng = np.random.RandomState(0)
    lines = []
    ramp = np.linspace(0.0, 2.0, 3840, dtype=np.float32)[None, :]
    for i in range(frames):
        scene = os.path.join(root, f"{i:05d}")
        for d in ("Image0", "Disp0", "Extrinsics0", "Extrinsics1"):
            os.makedirs(os.path.join(scene, d), exist_ok=True)
        rng.randint(0, 256, (2160, 3840, 3), dtype=np.uint8).tofile(
            os.path.join(scene, "Image0", "00000.raw"))
        blocks = np.kron(rng.uniform(2.0, 60.0, (9, 16)), np.ones((240, 240))).astype(np.float32)
        disp = blocks + ramp + rng.uniform(0.0, 1.0, (2160, 3840)).astype(np.float32)
        np.save(os.path.join(scene, "Disp0", "00000.npy"), disp)
        for name, tx in (("Extrinsics0", 0.0), ("Extrinsics1", -0.2)):
            with open(os.path.join(scene, name, "00000.txt"), "w") as f:
                f.write(f"1000.0 0.0 1920.0\n0.0 1.0 0.0 {tx}\n")
        lines.append(f"/{i:05d}/Image0/00000.raw")
    splits = {"train": lines, "val": lines[:2], "one": lines[:1], "four": lines[:4],
              "three": lines * 3}
    out = {"root": root}
    for name, ls in splits.items():
        out[name] = os.path.join(root, f"{name}.txt")
        with open(out[name], "w") as f:
            f.write("\n".join(ls) + "\n")
    return out


def write_cityscapes(root: str, frames: int) -> dict:
    """Cityscapes files at full size (1024x2048), made with a seeded numpy
    RNG: for each frame the ``leftImg8bit`` PNG, a uint16 ``disparity`` PNG
    (256 d + 1 over 128x128 blocks of d in (2, 60), 0 in a few invalid
    blocks), the ``camera`` json, a ``skyArea`` PNG (the top rows), the
    offline pseudo label ``<pl>/leftImg8bit_..._uint16.png`` (256 depth),
    and for the first two the gtFine colour map (label colours by block,
    the sky's (70, 130, 180) on top); a train split of every frame and a
    val split of the first two. Returns their paths."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(1)
    h, w = 1024, 2048
    pl_dir = os.path.join(root, "pl")
    os.makedirs(pl_dir, exist_ok=True)

    def png(rel, arr):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, compress_level=1)

    lines = []
    for i in range(frames):
        stem = f"smoke_{i:06d}_000019"
        img, dsp = (f"leftImg8bit/train/smoke/{stem}_leftImg8bit.png",
                    f"disparity/train/smoke/{stem}_disparity.png")
        png(img, rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        lab = rng.randint(0, 19, (h // 128, w // 128))
        d = np.kron(rng.uniform(2.0, 60.0, lab.shape), np.ones((128, 128)))
        stored = (d * 256.0 + 1.0).astype(np.uint16)
        stored[:128, :128] = 0
        png(dsp, stored)
        cam = os.path.join(root, f"camera/train/smoke/{stem}_camera.json")
        os.makedirs(os.path.dirname(cam), exist_ok=True)
        with open(cam, "w") as f:
            json.dump({"extrinsic": {"baseline": 0.209313}, "intrinsic": {"fx": 2262.52}}, f)
        sky = np.zeros((h, w), np.uint8)
        sky[:96] = 255
        png(f"skyArea/train/smoke/{stem}_skyArea.png", sky)
        depth = 0.209313 * 2262.52 / d
        png(os.path.join("pl", f"leftImg8bit_train_smoke_{stem}_leftImg8bit_uint16.png"),
            np.clip(depth * 256.0, 0, 65535).astype(np.uint16))
        if i < 2:
            seg = rng.randint(0, 256, (19, 3)).astype(np.uint8)[np.kron(lab, np.ones((128, 128), int))]
            seg[:96] = (70, 130, 180)
            png(f"gtFine/train/smoke/{stem}_gtFine_color.png", seg)
        lines.append(f"{img} {dsp}")
    out = {"root": root, "pl": pl_dir}
    for name, ls in (("train", lines), ("val", lines[:2])):
        out[name] = os.path.join(root, f"{name}.txt")
        with open(out[name], "w") as f:
            f.write("\n".join(ls) + "\n")
    return out


def waits_on(loader_waits: list, batch_keys: list):
    """A context in which every loader's iteration records, in the loop
    that consumes it, the host ms each batch was waited for and the keys of
    each batch."""
    from unittest import mock

    from patchrefinerv2_torch.datasets.base import DataLoader

    iterate = DataLoader.__iter__

    def timed_iter(self):
        it = iterate(self)
        try:
            while True:
                t0 = time.time()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                loader_waits.append((time.time() - t0) * 1e3)
                batch_keys.append(sorted(batch))
                yield batch
        finally:
            it.close()

    return mock.patch.object(DataLoader, "__iter__", timed_iter)


def loader_ms(config: str, options: list, workers: int) -> dict:
    """Host ms a batch of the config's train loader alone (batch 4,
    shuffled, prefetching on ``workers`` threads) over one pass of its
    split, and the first batch's latency."""
    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.datasets.base import DataLoader
    from patchrefinerv2_torch.train import build_dataset

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    cfg.merge_from_options(options)
    loader = DataLoader(build_dataset(cfg.train_dataloader.dataset), batch_size=4, shuffle=True,
                        num_workers=workers)
    t0, first, n = time.time(), None, 0
    for _ in loader:
        n += 1
        first = first or (time.time() - t0) * 1e3
    return {"workers": workers, "batches": n, "ms_per_batch": (time.time() - t0) * 1e3 / n,
            "first_batch_ms": first}


def sample_parts(config: str, options: list, samples: int = 4) -> dict:
    """Host ms of ``samples`` train samples of the config's dataset loaded
    one after the other in this thread, and of each transform in them
    (cProfile's cumulative time of the functions of
    ``datasets/transforms.py``; the rest is the reads, BGR to RGB and the
    float conversion), each a sample's mean; the global RNGs seeded 0, as
    the CLI seeds them."""
    import cProfile
    import pstats
    import random

    import numpy as np

    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.train import build_dataset

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    cfg.merge_from_options(options)
    ds = build_dataset(cfg.train_dataloader.dataset)
    random.seed(0)
    np.random.seed(0)
    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    for i in range(samples):
        ds[i % len(ds)]
    prof.disable()
    total = (time.time() - t0) * 1e3 / samples
    parts = {name: ct * 1e3 / samples for (path, _, name), (_, _, _, ct, _)
             in pstats.Stats(prof).stats.items() if path.endswith(os.path.join("datasets", "transforms.py"))}
    return {"samples": samples, "ms_per_sample": total, "transforms_ms": parts,
            "rest_ms": total - sum(v for k, v in parts.items() if k != "crop_bbox")}


def cli_train(label: str, config: str, options: list, kernels, exact_of=None,
              pseudo_label: bool = False, save: bool = True, keep: list | None = None) -> dict:
    """``patchrefinerv2_torch.train.main`` on ``config`` (its files by
    ``options``) on the card, each step counted (``count_step``: every
    kernel of ``kernels`` in every step, ``exact_of(model)`` exactly, no
    other kernel, no plain version, finite losses and gradients), the batch
    the step got holding the reader's ``pseudo_label`` when asked; the loop's
    wait on the loader and the step's ms recorded. ``save`` off skips the
    checkpoint write (a Semi student's is ~5 GB with its optimizer state);
    ``keep`` gets the model the run built. Returns the steps' counts, ms,
    start times (host seconds), waits and losses."""
    from unittest import mock

    from patchrefinerv2_torch import train as train_cli
    from patchrefinerv2_torch.training.trainer import Trainer

    build = train_cli.build_model

    def built(*a, **k):
        model = build(*a, **k)
        if keep is not None:
            keep.append(model)
        return model

    steps, times, starts, losses, waits, keys = [], [], [], [], [], []
    step = Trainer.train_step

    def counted(self, batch):
        starts.append(time.time())
        if pseudo_label and "pseudo_label" not in batch:
            raise AssertionError(f"{label}: the step's batch has no pseudo_label ({sorted(batch)})")
        exact = exact_of(self.model) if exact_of else None
        return count_step(lambda b: step(self, b), self.model, batch, label, kernels, exact, steps,
                          times, losses)

    def skip_save(self, epoch):
        log({"phase": f"{label}_checkpoint", "written": False, "epoch": epoch})

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    with mock.patch.object(Trainer, "train_step", counted), waits_on(waits, keys), \
            mock.patch.object(Trainer, "save", Trainer.save if save else skip_save), \
            mock.patch.object(train_cli, "build_model", built):
        train_cli.main([os.path.join(here, config), "--work-dir", os.path.join(WORK_DIR, label),
                        "--seed", "0", "--cfg-option", *options])
    out = {"counts": steps, "step_ms": times, "starts": starts, "loader_wait_ms": waits,
           "losses": losses, "seconds": time.time() - t0}
    log({"phase": label, **{k: v for k, v in out.items() if k not in ("counts", "starts")}})
    return out


def cli_test(label: str, config: str, options: list, frames: int, ref_counts: dict | None = None,
             idle_ok=(), args=(), process_num: int = 16, expect: str = "metrics") -> dict:
    """``patchrefinerv2_torch.test.main`` on ``config`` (its files and
    bfloat16 by ``options``; more flags in ``args``, m1 unless they say),
    with ``process_num``, on the card, the launch counters set to 0 just
    before and read just after: every kernel of the path but ``idle_ok``
    launched, K5 and K9 as the head's ``kernel_calls`` say a chunk, K8 4 +
    1 a frame, and with ``ref_counts`` (a full-width phase's run of the same
    network over the same number of frames) every kernel but K2 and canny
    (the metrics' own) as often; ``expect``: finite metrics (``"metrics"``),
    none (``"none"``: no ground truth) or one pseudo label written a frame
    (``"pseudo_labels"``: ``--test-type gen``). The host ms of each frame spent loading (on a loader
    thread), waited on, inferring and on the metrics are printed.

    ``expect="consistency"`` (``--test-type consistency``): ``frames``
    images of 16 crops run ``16 / process_num`` chunks each through the
    model's loss, each chunk's launches counted (their differences around
    the call): every chunk launches alike, K5 and K9 as the head's
    ``kernel_calls`` say, K1, K3 and K8 as ``ref_counts`` (a stage-3
    training step, whose coarse branch is not rematerialised) says; the
    error finite and above 0. ``expect="benchmark"``: ``frames`` is the
    count of inferred frames (the timed ones and ``model_complexity``'s);
    the fps and FLOPs above 0, the parameters the built net's.

    Returns the counts, the batches' keys, the metrics (or the pseudo
    labels' paths, or what the benchmark prints), each frame's depth on the
    host, each chunk's counts and the peak device bytes."""
    from unittest import mock

    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch import test as evaluate
    from patchrefinerv2_torch.datasets.base import DataLoader, DepthDataset
    from patchrefinerv2_torch.datasets.cityscapes import CityScapesDataset
    from patchrefinerv2_torch.datasets.scannet import ScanNetDataset

    models, infer_ms, metric_ms, load_ms, waits, keys, depths = [], [], [], [], [], [], []
    chunks = []
    build, load = evaluate.build_model, DataLoader._load

    def synced_ms(fn, into, keep=None):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            into.append((time.time() - t0) * 1e3)
            if keep is not None:
                keep.append(out[0].float().cpu().numpy())
            return out
        return run

    def chunk_counted(loss):
        def run(*a, **k):
            before = ops.launch_counts()
            out = loss(*a, **k)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            chunks.append({n: after[n] - before[n] for n in after})
            return out
        return run

    def built(*a, **k):
        model = build(*a, **k)
        model.infer = synced_ms(model.infer, infer_ms, None if expect == "benchmark" else depths)
        if expect == "consistency":
            model.loss = chunk_counted(model.loss)
        models.append(model)
        return model

    def timed_load(self, batch):
        t0 = time.time()
        out = load(self, batch)
        load_ms.append((time.time() - t0) * 1e3)
        return out

    here = os.path.dirname(os.path.abspath(__file__))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    timed_metrics = [mock.patch.object(cls, "get_metrics", synced_ms(cls.get_metrics, metric_ms))
                     for cls in (DepthDataset, CityScapesDataset, ScanNetDataset)]
    with mock.patch.object(evaluate, "build_model", built), waits_on(waits, keys), \
            mock.patch.object(DataLoader, "_load", timed_load), \
            timed_metrics[0], timed_metrics[1], timed_metrics[2]:
        out = evaluate.main([os.path.join(here, config), "--cai-mode", "m1", "--process-num",
                             str(process_num), *args, "--cfg-option", *options])
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    model = models[0]
    log({"phase": label, "result": out, "frames": len(infer_ms), "seconds": seconds,
         "load_ms_per_frame": load_ms, "loader_wait_ms_per_frame": waits,
         "infer_ms_per_frame": infer_ms, "metrics_ms_per_frame": metric_ms,
         "infer_dtype": str(model.infer_dtype), "max_memory_allocated": peak, "launches": counts})
    inferred = len(infer_ms)
    if expect == "pseudo_labels":
        ok = len(out["pseudo_labels"]) == frames and all(os.path.exists(p) for p in out["pseudo_labels"])
    elif expect == "consistency":
        inferred = len(chunks) * process_num // 16
        ok = sorted(out) == ["consistency", "consistency_error"] and 0 < out["consistency"] < math.inf
    elif expect == "benchmark":
        params = sum(p.numel() for p in model.net.parameters())
        ok = (out["benchmark"]["fps"] > 0 and out["complexity"]["flops"] > 0
              and out["complexity"]["params"] == params)
    else:
        ok = out == {} if expect == "none" else bool(out) and all(math.isfinite(v) for v in out.values())
    if inferred != frames or not ok:
        raise AssertionError(f"{label}: {inferred} frames, result {out}")
    idle = [k for k, v in counts.items() if v == 0 and k not in idle_ok]
    if idle:
        raise AssertionError(f"{label}: kernels never launched: {idle}")
    if expect == "consistency":
        check_chunk_launches(label, chunks, model, ref_counts)
        check_frame_launches(label, counts, model, len(chunks))
    else:
        check_frame_launches(label, counts, model, frames)
        off = {k: (counts[k], ref_counts[k]) for k in counts if ref_counts is not None
               and k not in ("resize", "canny_nms") and counts[k] != ref_counts[k]}
        if off:
            raise AssertionError(f"{label}: launches differ from the reference run's: {off}")
    del models, model
    torch.cuda.empty_cache()
    return {"counts": counts, "keys": keys, "result": out, "depths": depths, "chunks": chunks,
            "peak_bytes": peak}


# the kernels a stage-3 forward launches the same number of times in a
# training step (the coarse branch and K1 are not rematerialised)
STAGE3_EXACT = ("roi_align", "attention", "attractor_update", "log_binomial_depth")


def check_chunk_launches(label, chunks, model, stage3_step) -> None:
    """Every chunk of a consistency run launches alike: K1, K3 and K8 as a
    stage-3 training step of the same network and batch (``stage3_step``),
    K5 and K9 as the fusion head's ``kernel_calls`` say (a training step
    launches those twice: remat), K2 and K6; no other kernel."""
    head = model.net.refiner_fusion_model.kernel_calls()
    want = {**{k: stage3_step[k] for k in STAGE3_EXACT}, **head}
    log({"phase": f"{label}_chunk_launches", "chunks": len(chunks), "first": chunks[0], "want": want})
    other = {k: v for k, v in chunks[0].items() if v and k not in (*want, "resize", "layer_norm")}
    if (any(c != chunks[0] for c in chunks) or other or not chunks[0]["resize"]
            or not chunks[0]["layer_norm"] or any(chunks[0][k] != n for k, n in want.items())):
        raise AssertionError(f"{label}: chunk launches {chunks[0]} (all alike: "
                             f"{all(c == chunks[0] for c in chunks)}), want {want}, no other kernel")


# --test-type benchmark's frames in data_run: repeats x (warmup + timed)
BENCH_ITERS, BENCH_WARMUP, BENCH_REPEATS = 3, 1, 2
# the kernels a consistency run does not launch: no tiled inference, no metric
CONSISTENCY_IDLE_OK = ("crop_resize", "blend_add_pass", "blend_finalize", "quant_conv", "canny_nms",
                       "hysteresis_bounded")


def data_run(dev, flagship_m1: dict, cs_eval_m1: dict, stage3_step: dict, flagship_m1_ms: float) -> dict:
    """The data path at full width, through the entry points, on files it
    writes under ``DATA_DIR`` (random weights, seed 0):

    (a) UnrealStereo4K training: 8 frames at 2160x3840 (``write_u4k``); the
        host ms a batch of 4 of the train loader alone with 1 loader thread
        (1 batch) and 4 (6 batches), and of a sample by part
        (``sample_parts``); then ``train.main`` on ``pretrain_eff_m0s1.py``
        for 6 steps of batch 4 with 4 loader threads (the split that lists
        the frames three times), K2, K5, K6 and K9 in each step (as
        ``pretrain_run``), finite losses, the ms of each step and what it
        waited on the loader, and from step 3 on (the pipeline filled) the
        median wait and the median share of a step's period (from one
        step's start to the next) spent outside ``train_step``;
    (b) UnrealStereo4K evaluation: ``test.main`` on ``v2_eff_u4k.py``, m1,
        bfloat16, process_num 16, over the 2 val frames, its launches a
        chunk and a frame those of the ``flagship`` phase's m1 frame; then
        ``--test-type consistency`` (float32, process_num 4) over the first
        val frame through the config's consistency loader (the 16 crops of
        the 4x4 grid, augmented), each chunk's launches those of a stage-3
        step's forward (``stage3_step``; ``check_chunk_launches``), the error
        finite; and ``--test-type benchmark`` on that frame (m1,
        bfloat16, process_num 16, ``BENCH_*`` frames), its fps within 2x of
        the ``flagship`` phase's m1 bfloat16 frame (``flagship_m1_ms``), its FLOPs and parameters
        printed, the parameters the built net's;
    (c) Cityscapes: 8 frames at 1024x2048 (``write_cityscapes``); 2 steps
        of the offline Semi transfer (``plus_eff_cs_semi_offline_ssigm_ft``)
        through ``train.main``, the reader's pseudo label in each batch, the
        student's kernels counted as in ``semi_run``, the edge loss finite
        and not 0 (its checkpoint not written); then ``test.main`` on
        ``plus_eff_cs_pretrain.py`` in m1, bfloat16, over the 2 val frames,
        its launches those of the ``cityscapes_eval`` phase's m1 run but
        K2's and canny's: the reader's infer sample carries no
        ``seg_image`` (as the JAX reader's), so no boundary F1 and no canny.

    Returns the launch counts of each run for the kernels line."""
    import shutil

    t_phase = time.time()
    try:
        t0 = time.time()
        u4k = write_u4k(os.path.join(DATA_DIR, "u4k"), 8)
        log({"phase": "data_u4k_files", "frames": 8, "seconds": time.time() - t0})
        data = [f"train_dataloader.dataset.data_root={u4k['root']}"]
        host = [loader_ms(PRETRAIN_CONFIG, data + [f"train_dataloader.dataset.split={u4k[split]}"],
                          workers) for workers, split in ((1, "four"), (4, "three"))]
        log({"phase": "data_u4k_loader_host_ms", "batch": 4, "runs": host})
        log({"phase": "data_u4k_sample_host_ms",
             **sample_parts(PRETRAIN_CONFIG, data + [f"train_dataloader.dataset.split={u4k['train']}"],
                            2)})
        train = cli_train("data_u4k_train", PRETRAIN_CONFIG, data + [
            f"train_dataloader.dataset.split={u4k['three']}", "train_dataloader.batch_size=4",
            "train_dataloader.num_workers=4", "val_dataloader=None", "train_cfg.max_epochs=1",
            "train_cfg.log_interval=1", "train_cfg.save_checkpoint_interval=1"], TRAIN_KERNELS)
        if len(train["counts"]) != 6:
            raise AssertionError(f"data_u4k_train ran {len(train['counts'])} steps, not 6")
        periods = [(b - a) * 1e3 for a, b in zip(train["starts"], train["starts"][1:])]
        outside = [1.0 - ms / p for ms, p in zip(train["step_ms"], periods)]
        log({"phase": "data_u4k_train_vs_loader", "step_ms": train["step_ms"],
             "loader_wait_ms": train["loader_wait_ms"], "period_ms": periods,
             "share_outside_step": outside,
             "steady_from_step_3": {"median_step_ms": statistics.median(train["step_ms"][2:]),
                                    "median_wait_ms": statistics.median(train["loader_wait_ms"][2:]),
                                    "median_period_ms": statistics.median(periods[2:]),
                                    "median_share_outside_step": statistics.median(outside[2:])},
             "loader_host_ms_per_batch": {r["workers"]: r["ms_per_batch"] for r in host}})
        u4k_eval = cli_test("data_u4k_eval_bfloat16", STAGE3_CONFIG, [
            f"test_in_dataloader.dataset.data_root={u4k['root']}",
            f"test_in_dataloader.dataset.split={u4k['val']}", "model.config.infer_dtype=bfloat16"],
            2, {k: 2 * v for k, v in flagship_m1.items()}, idle_ok=FRAME_IDLE_OK)["counts"]
        consistency = cli_test("data_u4k_consistency_float32", STAGE3_CONFIG, [
            f"val_consistency_dataloader.dataset.data_root={u4k['root']}",
            f"val_consistency_dataloader.dataset.split={u4k['one']}",
            "val_consistency_dataloader.num_workers=1"], 1, stage3_step, idle_ok=CONSISTENCY_IDLE_OK,
            args=("--test-type", "consistency"), process_num=4, expect="consistency")
        bench = cli_test("data_u4k_benchmark_bfloat16", STAGE3_CONFIG, [
            f"test_in_dataloader.dataset.data_root={u4k['root']}",
            f"test_in_dataloader.dataset.split={u4k['one']}", "model.config.infer_dtype=bfloat16"],
            BENCH_REPEATS * (BENCH_WARMUP + BENCH_ITERS) + 1, idle_ok=FRAME_IDLE_OK, args=(
                "--test-type", "benchmark", "--bench-iters", str(BENCH_ITERS), "--bench-warmup",
                str(BENCH_WARMUP), "--bench-repeats", str(BENCH_REPEATS), "--work-dir",
                os.path.join(WORK_DIR, "benchmark")), expect="benchmark")
        fps, frame_ms = bench["result"]["benchmark"]["fps"], flagship_m1_ms
        with open(os.path.join(WORK_DIR, "benchmark", "benchmark.txt")) as f:
            written = f.read().splitlines()
        log({"phase": "data_u4k_benchmark_vs_flagship", **bench["result"],
             "flagship_m1_bfloat16_ms": frame_ms, "fps_times_frame_s": fps * frame_ms / 1e3,
             "benchmark_txt": written})
        if not 0.5 <= fps * frame_ms / 1e3 <= 2.0 or written[:2] != ["cai_mode: m1", "process_num: 16"]:
            raise AssertionError(f"the benchmark's {fps} fps against the flagship's {frame_ms} ms frame, "
                                 f"benchmark.txt {written}")

        t0 = time.time()
        cs = write_cityscapes(os.path.join(DATA_DIR, "cityscapes"), 8)
        log({"phase": "data_cs_files", "frames": 8, "seconds": time.time() - t0})
        semi = cli_train("data_cs_semi_offline", CS_OFFLINE_CONFIG, [
            f"train_dataloader.dataset.data_root={cs['root']}",
            f"train_dataloader.dataset.split={cs['train']}",
            f"train_dataloader.dataset.pseudo_label_path={cs['pl']}", "train_dataloader.batch_size=4",
            "train_dataloader.num_workers=4", "train_cfg.max_epochs=1", "train_cfg.log_interval=1"],
            SEMI_STUDENT_KERNELS, lambda m: semi_exact(m, False), pseudo_label=True, save=False)
        edge = [step["edge_loss"] for step in semi["losses"]]
        if len(edge) != 2 or not all(math.isfinite(e) and e != 0.0 for e in edge):
            raise AssertionError(f"data_cs_semi_offline: edge losses {edge}")
        cs_run = cli_test("data_cs_eval_bfloat16", CS_PRETRAIN_CONFIG, [
            "test_in_dataloader=None", f"val_dataloader.dataset.data_root={cs['root']}",
            f"val_dataloader.dataset.split={cs['val']}", "model.config.infer_dtype=bfloat16"],
            2, cs_eval_m1, idle_ok=("quant_conv", "hysteresis_bounded", "canny_nms"))
        cs_eval, keys = cs_run["counts"], cs_run["keys"]
        log({"phase": "data_cs_infer_sample", "keys": keys[0],
             "seg_image": any("seg_image" in k for k in keys), "as_in_jax": True})
        if any("seg_image" in k for k in keys):
            raise AssertionError("the Cityscapes infer sample carries seg_image, unlike the JAX reader's")
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    log({"phase": "seconds", "of": "data_run_total", "s": time.time() - t_phase})
    return {"data_u4k_train_f32": train["counts"][0], "data_u4k_eval_bf16": u4k_eval,
            "data_u4k_consistency_f32": consistency["counts"],
            "data_u4k_benchmark_bf16": bench["counts"],
            "data_cs_semi_offline_f32": semi["counts"][0], "data_cs_eval_bf16": cs_eval}


KITTI_CONFIG = "configs/patchrefinerv2_zoedepth_kitti/plus_eff_onlyreal.py"
KITTI_SEMI_CONFIG = "configs/patchrefinerv2_zoedepth_kitti/semi_eff.py"
SCANNET_CONFIG = "configs/patchrefinerv2_zoedepth_scannet/plus_eff_onlyreal.py"
ETH_DATASET_CONFIG = "configs/_base_/datasets/eth.py"


def _png(path: str, arr) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, compress_level=1)


def write_kitti(root: str, frames: int) -> dict:
    """KITTI files at the raw size (375x1242), made with a seeded numpy RNG:
    for each frame an RGB PNG named ``NNNNNN.png`` in ``root`` itself (a
    flat name: the reader's pseudo-label name and ``gen``'s agree only for
    those) and a uint16 depth PNG under ``gt/`` (256 x depth over 25x54
    blocks of depth in (2, 80), ~5% of the pixels valid, as LiDAR gives);
    a split of every frame. Returns their paths."""
    import numpy as np

    rng = np.random.RandomState(2)
    h, w = 375, 1242
    lines = []
    for i in range(frames):
        name = f"{i:06d}.png"
        _png(os.path.join(root, name), rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        depth = np.kron(rng.uniform(2.0, 80.0, (h // 25, w // 54)), np.ones((25, 54)))
        _png(os.path.join(root, "gt", name),
             np.where(rng.rand(h, w) < 0.05, depth * 256.0, 0.0).astype(np.uint16))
        lines.append(f"{name} gt/{name}")
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"root": root, "split": split}


def write_scannet(root: str, frames: int) -> dict:
    """ScanNet++ files (1440x1920 RGB PNGs and uint16 depth PNGs, 1000 x depth
    over 120x120 blocks of depth in (0.5, 9)), made with a seeded numpy RNG;
    the second frame's depth at 720x960, so that the reader resizes it by
    the nearest rule. Returns the root and the split."""
    import numpy as np

    rng = np.random.RandomState(3)
    lines = []
    for i in range(frames):
        img, dep = f"scene{i}/rgb/DSC{i:05d}.png", f"scene{i}/depth/DSC{i:05d}.png"
        _png(os.path.join(root, img), rng.randint(0, 256, (1440, 1920, 3), dtype=np.uint8))
        h, w, b = (1440, 1920, 120) if i != 1 else (720, 960, 60)
        depth = np.kron(rng.uniform(0.5, 9.0, (h // b, w // b)), np.ones((b, b)))
        _png(os.path.join(root, dep), (depth * 1000.0).astype(np.uint16))
        lines.append(f"{img} {dep}")
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"root": root, "split": split}


def write_eth3d(root: str) -> dict:
    """One ETH3D frame: a 4032x6048 RGB PNG and its float32 ``.raw`` depth
    (252x252 blocks of depth in (0.5, 30), a NaN and an infinity in the
    first row), made with a seeded numpy RNG, a split, and a config on the
    flagship with the val loader of ``configs/_base_/datasets/eth.py`` on
    them. Returns the config's path."""
    import numpy as np

    rng = np.random.RandomState(4)
    img, dep = "courtyard/images/DSC_0001.png", "courtyard/depth/DSC_0001.raw"
    _png(os.path.join(root, img), rng.randint(0, 256, (4032, 6048, 3), dtype=np.uint8))
    depth = np.kron(rng.uniform(0.5, 30.0, (16, 24)), np.ones((252, 252))).astype(np.float32)
    depth[0, :2] = (np.nan, np.inf)
    os.makedirs(os.path.dirname(os.path.join(root, dep)), exist_ok=True)
    depth.tofile(os.path.join(root, dep))
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write(f"{img} {dep}\n")
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(root, "eth3d_flagship.py")
    with open(config, "w") as f:
        f.write(f"_base_ = [{os.path.join(here, STAGE3_CONFIG)!r}, "
                f"{os.path.join(here, ETH_DATASET_CONFIG)!r}]\n"
                f"test_in_dataloader = None\n"
                f"val_dataloader = dict(dataset=dict(data_root={root!r}, split={split!r}))\n")
    return config


def write_images(root: str) -> dict:
    """A folder of images for the ``general`` type: a raw 2160x3840 BGR blob
    (``a.raw``) and a 1000x1500 RGB PNG (``b.png``, which the reader resizes
    to 2160x3840 by its bicubic path), made with a seeded numpy RNG."""
    import numpy as np

    rng = np.random.RandomState(5)
    os.makedirs(root, exist_ok=True)
    rng.randint(0, 256, (2160, 3840, 3), dtype=np.uint8).tofile(os.path.join(root, "a.raw"))
    _png(os.path.join(root, "b.png"), rng.randint(0, 256, (1000, 1500, 3), dtype=np.uint8))
    return {"root": root, "png": os.path.join(root, "b.png")}


def datasets_run(dev, flagship_m1: dict) -> dict:
    """The other readers and the ``general`` / ``gen`` test types at full
    width, through the entry points, on files written under ``DATA_DIR``
    (random weights, seed 0), each frame's loading, inference and metric
    host ms printed by ``cli_test``:

    (a) KITTI: 4 frames at 375x1242 (``write_kitti``); ``test.main`` on
        ``plus_eff_onlyreal.py`` (352x1216 split 2x4, one chunk of 8) in m1
        and m2, bfloat16, finite metrics, K5 and K9 a chunk and K8 4 + 1 a
        frame; ``--test-type gen`` on the same config over the frames as a
        folder (``dataset_name=kitti``: the KB crop), each pseudo label
        reading back equal to ``save_raw_16bit`` of the depth ``infer``
        returned; then 2 steps of batch 2 of ``semi_eff.py`` through
        ``train.main`` on those pseudo labels (each step counted as in
        ``semi_run``, finite losses; no checkpoint written);
    (b) ScanNet++: 2 frames at 1440x1920, one depth at 720x960
        (``write_scannet``); ``test.main`` on its ``plus_eff_onlyreal.py``
        (split 2x2), m1, bfloat16: the ``edge_*`` and ``flat_*`` metrics
        present and finite;
    (c) ETH3D: one 4032x6048 frame with a ``.raw`` depth (``write_eth3d``);
        ``test.main`` with the flagship and ``eth.py``'s val loader at
        ``--image-raw-shape 4032 6048 --patch-split-num 2 2``, m1, bfloat16,
        finite metrics, the peak device memory printed;
    (d) ``test.main --test-type general --save`` on ``v2_eff_u4k.py``, m1,
        bfloat16, over a raw 4K blob and a 1000x1500 PNG (``write_images``):
        both PNGs written for each image, launches twice the flagship m1
        frame's but K2's; the host ms of the PNG's bicubic read printed.

    Returns the launch counts of each run for the kernels line."""
    import shutil

    import cv2
    import numpy as np

    from patchrefinerv2_torch.datasets.general import read_general_image
    from patchrefinerv2_torch.utils.color import save_raw_16bit

    t_phase, runs = time.time(), {}
    bf16 = "model.config.infer_dtype=bfloat16"
    try:
        t0 = time.time()
        kitti = write_kitti(os.path.join(DATA_DIR, "kitti"), 4)
        log({"phase": "datasets_kitti_files", "frames": 4, "seconds": time.time() - t0})
        val = ["test_in_dataloader=None", f"val_dataloader.dataset.data_root={kitti['root']}",
               f"val_dataloader.dataset.split={kitti['split']}", bf16]
        for mode in ("m1", "m2"):
            runs[f"datasets_kitti_eval_{mode}_bf16"] = cli_test(
                f"datasets_kitti_eval_{mode}_bfloat16", KITTI_CONFIG, val, 4, idle_ok=FRAME_IDLE_OK,
                args=["--cai-mode", mode], process_num=8)["counts"]
        pl_dir = os.path.join(DATA_DIR, "kitti_pl")
        gen = cli_test("datasets_kitti_gen_bfloat16", KITTI_CONFIG, [
            f"general_dataloader.dataset.rgb_image_dir={kitti['root']}",
            "general_dataloader.dataset.dataset_name=kitti", bf16], 4, idle_ok=FRAME_IDLE_OK,
            args=["--test-type", "gen", "--work-dir", pl_dir], process_num=8, expect="pseudo_labels")
        runs["datasets_kitti_gen_bf16"] = gen["counts"]
        ref = os.path.join(DATA_DIR, "ref_uint16.png")
        for path, depth in zip(gen["result"]["pseudo_labels"], gen["depths"]):
            save_raw_16bit(depth, ref)
            got, want = (cv2.imread(p, cv2.IMREAD_UNCHANGED) for p in (path, ref))
            if got.dtype != np.uint16 or got.shape != depth.shape or not np.array_equal(got, want):
                raise AssertionError(f"{path}: the pseudo label is not save_raw_16bit of the depth")
        log({"phase": "datasets_kitti_gen_files", "written": gen["result"]["pseudo_labels"],
             "shape": list(gen["depths"][0].shape), "equal_to_save_raw_16bit": True})
        semi = cli_train("datasets_kitti_semi_offline", KITTI_SEMI_CONFIG, [
            f"train_dataloader.dataset.data_root={kitti['root']}",
            f"train_dataloader.dataset.split={kitti['split']}",
            f"train_dataloader.dataset.pseudo_label_path={pl_dir}", "train_dataloader.batch_size=2",
            "train_dataloader.num_workers=2", "val_dataloader=None", "train_cfg.max_epochs=1",
            "train_cfg.log_interval=1"],
            SEMI_STUDENT_KERNELS, lambda m: semi_exact(m, False), pseudo_label=True, save=False)
        if len(semi["counts"]) != 2:
            raise AssertionError(f"datasets_kitti_semi_offline ran {len(semi['counts'])} steps, not 2")
        runs["datasets_kitti_semi_offline_f32"] = semi["counts"][0]

        t0 = time.time()
        sn = write_scannet(os.path.join(DATA_DIR, "scannet"), 2)
        log({"phase": "datasets_scannet_files", "frames": 2, "seconds": time.time() - t0})
        scannet = cli_test("datasets_scannet_eval_bfloat16", SCANNET_CONFIG, [
            "test_in_dataloader=None", f"val_dataloader.dataset.data_root={sn['root']}",
            f"val_dataloader.dataset.split={sn['split']}", bf16], 2, idle_ok=FRAME_IDLE_OK,
            process_num=4)
        split_keys = [k for k in scannet["result"] if k.startswith(("edge_", "flat_"))]
        if not any(k.startswith("edge_") for k in split_keys) or not any(
                k.startswith("flat_") for k in split_keys):
            raise AssertionError(f"datasets_scannet: no edge_ / flat_ metrics in {scannet['result']}")
        runs["datasets_scannet_eval_bf16"] = scannet["counts"]

        t0 = time.time()
        eth_config = write_eth3d(os.path.join(DATA_DIR, "eth3d"))
        log({"phase": "datasets_eth3d_files", "frames": 1, "seconds": time.time() - t0})
        eth = cli_test("datasets_eth3d_eval_bfloat16", eth_config, [bf16], 1, idle_ok=FRAME_IDLE_OK,
                       args=["--image-raw-shape", "4032", "6048", "--patch-split-num", "2", "2"],
                       process_num=4)
        log({"phase": "datasets_eth3d_peak_memory", "max_memory_allocated": eth["peak_bytes"]})
        runs["datasets_eth3d_eval_bf16"] = eth["counts"]

        images = write_images(os.path.join(DATA_DIR, "images"))
        t0 = time.time()
        read_general_image(images["png"], "", (2160, 3840))
        log({"phase": "datasets_general_bicubic_read", "source": [1000, 1500], "to": [2160, 3840],
             "host_ms": (time.time() - t0) * 1e3})
        out_dir = os.path.join(DATA_DIR, "general_out")
        general = cli_test("datasets_general_save_bfloat16", STAGE3_CONFIG, [
            f"general_dataloader.dataset.rgb_image_dir={images['root']}", bf16], 2,
            {k: 2 * v for k, v in flagship_m1.items()}, idle_ok=FRAME_IDLE_OK,
            args=["--test-type", "general", "--save", "--work-dir", out_dir], expect="none")
        written = sorted(os.listdir(out_dir))
        shapes = [list(cv2.imread(os.path.join(out_dir, f), cv2.IMREAD_UNCHANGED).shape) for f in written]
        canvas = list(general["depths"][0].shape)  # the reensemble canvas, 1536x2048
        log({"phase": "datasets_general_files", "written": written, "shapes": shapes})
        if written != ["a.png", "a_uint16.png", "b.png", "b_uint16.png"] or shapes != [
                canvas + [3], canvas] * 2:
            raise AssertionError(f"datasets_general: wrote {written} of shapes {shapes}")
        runs["datasets_general_bf16"] = general["counts"]
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    log({"phase": "seconds", "of": "datasets_run_total", "s": time.time() - t_phase})
    return runs


BASELINE_ZOE_CONFIG = "configs/patchrefinerv2_zoedepth/coarse_pretrain_u4k.py"
BASELINE_DA2_CONFIG = "configs/patchrefinerv2_dav2/coarse_pretrain_u4k.py"
BASELINE_FINE_CONFIG = "configs/patchfusion_zoedepth/zoedepth_fine_pretrain_u4k.py"
BASELINE_KERNELS = ("resize", "layer_norm", "attention", "attractor_update", "log_binomial_depth")
BASELINE_DA2_KERNELS = ("resize", "layer_norm", "attention")  # no bins head


def baseline_train_options(config: str, batch: int = 4, steps: int = 3) -> list:
    """``--cfg-option``s of a stage-1 run of ``config`` on the card: batch 4
    of SyntheticDataset frames (2160x3840, ``image_lr`` at the network's
    384x512 or DA2's 448x448, 540x960 crops resized likewise), ``steps``
    steps in one epoch, no validation."""
    process = [448, 448] if "dav2" in config else [384, 512]
    ds = dict(type="SyntheticDataset", mode="train", length=batch * steps,
              network_process_size=process)
    return [f"train_dataloader.dataset={ds!r}", f"train_dataloader.batch_size={batch}",
            "train_dataloader.num_workers=2", "val_dataloader=None", "train_cfg.max_epochs=1",
            "train_cfg.log_interval=1", "train_cfg.save_checkpoint_interval=1"]


def baseline_config(config: str, batch: int = 4, steps: int = 3):
    """The stage-1 config with ``baseline_train_options`` applied, for
    ``make_trainer``."""
    from patchrefinerv2_torch.config import Config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Config.fromfile(os.path.join(here, config))
    cfg.merge_from_options(baseline_train_options(config, batch, steps))
    cfg["seed"] = 0
    return cfg


def baseline_exact(model) -> dict:
    """A stage-1 step's launches of the counted kernels but K2, from the
    network's modules: K3 or K4 at each block, K6 at its LayerNorms, K8 at
    each attractor layer and once for the log-binomial depth."""
    return model.net.branch.kernel_calls()


def check_baseline_frame(label: str, counts: dict, model, chunks: int, finalizes: int) -> None:
    """A fine-target frame's launches: the network's ``kernel_calls`` once a
    chunk, one crop-resize and one add_pass a chunk, ``finalizes`` finalize,
    the DPT neck's K2, and no other kernel."""
    want = {k: chunks * n for k, n in baseline_exact(model).items()}
    want.update(crop_resize=chunks, blend_add_pass=chunks, blend_finalize=finalizes)
    got = {k: counts[k] for k in want}
    other = {k: v for k, v in counts.items() if k not in want and k != "resize" and v}
    log({"phase": f"{label}_launches", "chunks": chunks, "launches": counts})
    if got != want or other or not counts["resize"]:
        raise AssertionError(f"{label}: launches {got} (other {other}, resize {counts['resize']}) "
                             f"for {chunks} chunks, not {want}")


def baseline_run(dev) -> dict:
    """Stage 1 (BaselinePretrain) at full width on the card, through
    ``python -m patchrefinerv2_torch.train`` (random weights, seed 0):

    (a) 3 steps of ``coarse_pretrain_u4k.py`` (BEiT-L/16 ZoeDepth, batch 4
        of 384x512 images against 2160x3840 depth), then 2 of the DA2
        ``patchrefinerv2_dav2/coarse_pretrain_u4k.py`` (DINOv2-L + DPT at
        448x448, the position embedding resized bicubically under grad) and
        2 of ``zoedepth_fine_pretrain_u4k.py`` (the fine target: 540x960
        crops resized to 384x512), float32, TF32 off; each step counted
        (``count_step``: the network's K3 or K4, K6 and K8 launches exactly,
        K2, no other kernel, no plain version, finite losses and
        gradients), with ms a step and peak memory; the ZoeDepth run writes
        its checkpoint, and the DA2 network is saved as ``DA2_STAGE1`` for
        ``da2_train_run``;
    (b) the hand-off: ``v2_eff_u4k.py`` built on the card with that
        checkpoint as its ``pretrain_coarse_model``: every tensor of the
        checkpoint taken, the coarse branch equal to it;
    (c) the fine network just trained on a 2160x3840 frame split 4x4 with
        process_num 16: an m1 frame (one chunk) and an r8 frame (the four
        regular passes, then 8 random chunks of 16), each a
        first frame with its launches held to the network's (a chunk) and
        a warm frame timed; finite depth on the reensemble (m1) or raw (r8)
        canvas.

    Returns the launch counts of each run for the kernels line."""
    import numpy as np
    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.config import Config
    from patchrefinerv2_torch.models.patchrefiner import build_model
    from patchrefinerv2_torch.models.tiling import regular_pass
    from patchrefinerv2_torch.utils.checkpoint import (
        apply_config_pretrained, load_checkpoint, save_checkpoint,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    out, fine = {}, []
    for label, config, steps, kernels, save in (
            ("baseline_zoe", BASELINE_ZOE_CONFIG, 3, BASELINE_KERNELS, True),
            ("baseline_da2", BASELINE_DA2_CONFIG, 2, BASELINE_DA2_KERNELS, False),
            ("baseline_fine", BASELINE_FINE_CONFIG, 2, BASELINE_KERNELS, False)):
        torch.cuda.reset_peak_memory_stats()
        keep = fine if label == "baseline_fine" else []
        run = cli_train(label, config, baseline_train_options(config, 4, steps), kernels,
                        baseline_exact, save=save, keep=keep)
        if len(run["counts"]) != steps:
            raise AssertionError(f"{label} ran {len(run['counts'])} steps, not {steps}")
        log({"phase": f"{label}_train", "steps": steps, "step_ms": run["step_ms"],
             "warm_step_ms": statistics.median(run["step_ms"][1:]),
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "params": sum(p.numel() for p in keep[-1].net.parameters()) if keep else None})
        out[f"{label}_train_f32"] = run["counts"][0]
        if label == "baseline_da2":  # the DA2 recipe's stage-1 network (``da2_train_run``)
            save_checkpoint(DA2_STAGE1, {"state_dict": keep[-1].net.state_dict(), "epoch": 1,
                                         "step": steps})
        del run, keep
        torch.cuda.empty_cache()

    ckpt = os.path.join(WORK_DIR, "baseline_zoe", "checkpoint_01")
    cfg = Config.fromfile(os.path.join(here, STAGE3_CONFIG))
    cfg.merge_from_options([f"model.config.pretrain_coarse_model={ckpt!r}"])
    t0 = time.time()
    model = build_model(cfg.model, device=dev, seed=0)
    report = apply_config_pretrained(model)
    sd = load_checkpoint(ckpt)["state_dict"]
    own = model.net.state_dict()
    off = [k for k, v in sd.items() if not k.startswith("coarse_branch.")
           or not torch.equal(own[k], v.to(dev))]
    log({"phase": "baseline_handoff", "checkpoint_tensors": len(sd),
         "report": report.get("pretrain_coarse_model"), "unequal": off[:8], "seconds": time.time() - t0})
    if off or report.get("pretrain_coarse_model", {}).get("taken") != len(sd):
        raise AssertionError(f"pretrain_coarse_model took {report} of {len(sd)} tensors; unequal {off[:8]}")
    del model, own, sd
    torch.cuda.empty_cache()

    model = fine[0].eval()
    g = torch.Generator(device=dev).manual_seed(0)
    hr = torch.rand((1, 2160, 3840, 3), generator=g, device=dev)
    tc = model.tile_cfg
    regular = sum(-(-len(regular_pass(tc, off, 16).starts_raw) // 16)
                  for off in ((0, 0), (0, 1), (1, 0), (1, 1)))
    for mode, chunks, finalizes, canvas in (("m1", 1, 1, tc.patch_reensemble_shape),
                                            ("r8", regular + 8, 2, tc.image_raw_shape)):
        label = f"baseline_fine_{mode}_f32"
        infer = lambda: model.infer(None, hr, mode, process_num=16,  # noqa: E731
                                    generator=torch.Generator().manual_seed(0))[0]
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        depth = infer()
        torch.cuda.synchronize()
        first = (time.time() - t0) * 1e3
        counts = ops.launch_counts()
        check_baseline_frame(label, counts, model, chunks, finalizes)
        t0 = time.time()
        infer()
        torch.cuda.synchronize()
        warm = (time.time() - t0) * 1e3
        d = depth.float().cpu().numpy()
        log({"phase": label, "shape": list(d.shape), "first_ms": first, "warm_ms": warm,
             "peak_bytes": torch.cuda.max_memory_allocated(), "depth_min_max": [float(d.min()), float(d.max())]})
        if tuple(d.shape) != tuple(canvas) or not np.isfinite(d).all():
            raise AssertionError(f"{label}: depth {d.shape}, finite {np.isfinite(d).all()}")
        out[label] = counts
    del model, fine, depth
    torch.cuda.empty_cache()
    return out


def tiny_baseline_gpu_vs_cpu(dev) -> None:
    """BaselinePretrain's graphs at a small size on the card against the
    CPU, float32, from the same weights: a DA2 (``vitt``) coarse step of
    batch 2 at 56x84 (the position embedding's bicubic K2 and its backward,
    K4 with its backward) within ``compare_train_steps``' bars, and the tiny
    BEiT ZoeDepth fine target's m2 and r2 depth (process_num 4, the same
    random starts) within 1e-4 of the CPU's magnitude."""
    import numpy as np
    import torch

    from patchrefinerv2_torch.models.baseline_pretrain import BaselinePretrain

    def cfg(target, branch, patch):
        return dict(target=target, image_raw_shape=[96, 128], patch_process_shape=patch,
                    patch_split_num=[2, 2], **{f"{target}_branch": branch})

    da2 = cfg("coarse", dict(type="DA2", model_cfg=dict(encoder="vitt", features=64)), [56, 84])
    rng = np.random.RandomState(5)
    batch = dict(image_lr=rng.rand(2, 56, 84, 3).astype(np.float32),
                 depth_gt=(1.0 + 20.0 * rng.rand(2, 96, 128, 1)).astype(np.float32))
    out = []
    for d in (dev, "cpu"):
        m = BaselinePretrain(da2, device=d, seed=3).train()
        out.append(_step_result(m, m.loss(batch, update_stats=True)[0]))
    compare_train_steps("tiny_baseline_da2_gpu_vs_cpu", *out)
    fine = cfg("fine", TINY_ZOE["coarse_branch"], [48, 64])
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    starts = np.stack([np.stack([rng.randint(0, 48, 4), np.full(4, rng.randint(0, 64))], -1)
                       for _ in range(2)]).astype(np.int32)
    for mode in ("m2", "r2"):
        depths = [BaselinePretrain(fine, device=d, seed=3).infer(
            hr[:, ::2, ::2], hr, mode, process_num=4,
            random_starts=starts if mode == "r2" else None)[0].cpu() for d in (dev, "cpu")]
        err = float((depths[0] - depths[1]).abs().max()) / float(depths[1].abs().max())
        log({"phase": f"tiny_baseline_fine_{mode}_gpu_vs_cpu", "max_rel_of_magnitude": err, "bar": 1e-4})
        if not err <= 1e-4:
            raise AssertionError(f"tiny BaselinePretrain {mode}: the card disagrees with the CPU ({err})")


DA2_PRETRAIN_CONFIG = "configs/patchrefinerv2_dav2/pretrain_eff_m0s1.py"
DA2_STAGE3_CONFIG = "configs/patchrefinerv2_dav2/plus_eff_u4k_base_coarse_e2e_c2f_pretrain.py"
DA2_SEMI_CONFIG = "configs/patchrefinerv2_dav2/semi_kitti.py"
DA2_PRETRAINED = os.path.join(WORK_DIR, "da2_pretrain", "checkpoint_01")  # the DA2 pretraining run's
DA2_STAGE1 = os.path.join(WORK_DIR, "baseline_da2", "stage1_network")  # baseline_run's DA2 network
# the DA2 Semi student's kernels (the coarse branch forward only, under no gradient)
DA2_SEMI_KERNELS = ("resize", "layer_norm", "attention", "tail_conv", "gate_tail", "roi_align")


def da2_train_run(dev, chk: Checks) -> dict:
    """The Depth-Anything-V2 recipe at full width on the card (DINOv2-L with
    the DPT head at 448x448, EfficientNet-B5 or two DINOv2-L networks,
    batch 4, float32, TF32 off), each step counted (``count_step``: its
    kernels in every step, those with a count from the modules exactly, no
    other kernel and no plain version, finite losses and gradients), its ms
    and the run's peak memory printed:

    (a) refiner pretraining, ``patchrefinerv2_dav2/pretrain_eff_m0s1.py``
        (the hacked coarse level 5 128 wide), 3 steps through
        ``Trainer.run``, writing its checkpoint;
    (b) stage 3 from that checkpoint,
        ``plus_eff_u4k_base_coarse_e2e_c2f_pretrain.py`` (``e2e_training``):
        3 steps, K1 7 times and K4 24 times a step exactly, K2, K5, K6 and K9
        in every step, no K3 (24 launches are the DINOv2's blocks), no K8;
        the coarse branch, the refiner, the fusion head and the BatchNorm
        statistics move; the first step's training sites checked (path
        ``train_da2_e2e_backward``, that step without remat); then the m1
        validation of one 2160x3840 frame (448x448 ``image_lr``) in float32;
    (c) V1, ``patchrefiner_dav2/pr_u4k.py``, with ``baseline_run``'s DA2
        network as its ``pretrain_coarse_model`` and ``pretrain_fine_model``
        (``v1_train_run``): 3 steps, the fine DINOv2 and FusionUnet move,
        the coarse branch stays the stage-1 network; its first step's
        training sites checked (path ``train_v1_da2_backward``);
    (d) ``semi_kitti.py``'s DA2 student (``da2_semi_kitti``).

    Returns the first step's launches of each run for the kernels line."""
    import torch

    out = {}
    out["da2_pretrain_f32"] = timed(pretrain_run, dev, DA2_PRETRAIN_CONFIG, "da2_pretrain", DA2_PRETRAINED,
                                    False)
    out["da2_stage3_f32"] = timed(stage3_run, dev, DA2_STAGE3_CONFIG, "da2_stage3", DA2_PRETRAINED, True,
                                  False, (chk, "train_da2_e2e_backward"))
    out["v1_da2_train_f32"] = timed(v1_train_run, dev, V1_DA2_CONFIG, "v1_da2_train", DA2_STAGE1, False,
                                    (chk, "train_v1_da2_backward"))
    out.update(timed(da2_semi_kitti, dev))
    torch.cuda.empty_cache()
    return out


def da2_semi_kitti(dev) -> dict:
    """``semi_kitti.py``'s DA2 student through ``patchrefinerv2_torch.train.main``
    on KITTI files under ``DATA_DIR`` (``write_kitti``: 8 frames at
    375x1242, random weights, seed 0): the offline pseudo labels written as
    the ``gen`` test type writes them (``save_raw_16bit``, named from the
    image path as the reader reads them; here smooth random depths at the
    352x1216 crop), 2 steps of batch 4 (448x448 images and crops, remat on,
    the coarse branch forward only), each counted as ``semi_run`` counts its
    steps (K1 7 times, no K8, K11 or K12); then the validation of one frame
    (``val_interval`` 1) with the val loader's image at ``KITTI_DA2_LR``,
    which the Depth-Anything resizer rounds to 448x448: the launch counters
    set to 0 just before it and read just after, K2's image resize
    recorded, K5 and K9 as the head's ``kernel_calls`` say a chunk, finite
    metrics. Returns the first step's launches and the validation's."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from patchrefinerv2_torch import ops
    from patchrefinerv2_torch.datasets.kitti import KittiDataset
    from patchrefinerv2_torch.models import patchrefinerplus as prp
    from patchrefinerv2_torch.training.trainer import Trainer
    from patchrefinerv2_torch.utils.color import save_raw_16bit

    try:
        t0 = time.time()
        kitti = write_kitti(os.path.join(DATA_DIR, "kitti_da2"), 8)
        pl_dir = os.path.join(DATA_DIR, "kitti_da2_pl")
        os.makedirs(pl_dir)
        rng = np.random.RandomState(7)
        names = [line.split()[0] for line in open(kitti["split"]).read().splitlines()]
        for name in names:
            depth = np.kron(rng.uniform(2.0, 80.0, (11, 38)), np.ones((32, 32))).astype(np.float32)
            save_raw_16bit(depth, os.path.join(pl_dir, KittiDataset._pseudo_name(name)))
        val_split = os.path.join(DATA_DIR, "kitti_da2_val.txt")
        with open(val_split, "w") as f:
            f.write(open(kitti["split"]).read().splitlines()[0] + "\n")
        log({"phase": "da2_semi_kitti_files", "frames": len(names), "seconds": time.time() - t0})
        orig_val, resize, val = Trainer.val_epoch, prp.resize, {}

        def counted_val(self):
            calls = []

            def spy(x, size, *a, **k):
                calls.append([list(x.shape), list(size)])
                return resize(x, size, *a, **k)

            ops.reset_launches()
            torch.cuda.synchronize()
            t1 = time.time()
            with mock.patch.object(prp, "resize", spy):
                metrics = orig_val(self)
            torch.cuda.synchronize()
            val.update(metrics=metrics, ms=(time.time() - t1) * 1e3, counts=ops.launch_counts(),
                       orchestrator_resizes=calls, model=self.model)
            return metrics

        with mock.patch.object(Trainer, "val_epoch", counted_val):
            semi = cli_train("da2_semi_kitti", DA2_SEMI_CONFIG, [
                f"train_dataloader.dataset.data_root={kitti['root']}",
                f"train_dataloader.dataset.split={kitti['split']}",
                f"train_dataloader.dataset.pseudo_label_path={pl_dir}", "train_dataloader.batch_size=4",
                "train_dataloader.num_workers=2", f"val_dataloader.dataset.data_root={kitti['root']}",
                f"val_dataloader.dataset.split={val_split}",
                f"val_dataloader.dataset.transform_cfg.network_process_size={list(KITTI_DA2_LR)}",
                "train_cfg.max_epochs=1", "train_cfg.val_interval=1", "train_cfg.log_interval=1"],
                DA2_SEMI_KERNELS, lambda m: semi_exact(m, False), pseudo_label=True, save=False)
        if len(semi["counts"]) != 2:
            raise AssertionError(f"da2_semi_kitti ran {len(semi['counts'])} steps, not 2")
        model, counts, metrics = val.pop("model"), val["counts"], val["metrics"]
        log({"phase": "da2_semi_kitti_val_float32", **val})
        image_resize = [[1, *KITTI_DA2_LR, 3], list(model.student.coarse_input_shape(KITTI_DA2_LR))]
        if image_resize not in val["orchestrator_resizes"] or \
                image_resize[1] != list(model.student.patch_input_shape):
            raise AssertionError(f"da2_semi_kitti: no resizer call {image_resize} in "
                                 f"{val['orchestrator_resizes']}")
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"da2_semi_kitti's validation frame gave {metrics}")
        check_frame_launches("da2_semi_kitti_val", counts, model.student, 1, bins=(0, 0))
        return {"da2_semi_kitti_f32": semi["counts"][0], "da2_semi_kitti_val_f32": counts}
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)


def tiny_da2_train_gpu_vs_cpu(dev) -> None:
    """A tiny DA2 stage-3 step (a ``vitt`` DINOv2 of 64 features with its
    DPT head, the EfficientNet-B5 refiner and BiDirectionalFusion, 56x84
    patches, batch 2, ``e2e_training`` and remat on) and a tiny DA2 V1 step
    (``vitt`` coarse and fine networks, a narrow FusionUnet) on the card
    (K1, K4, the bicubic K2 and the rest, their backwards) against the CPU
    (the plain versions), from the same weights and batch, within
    ``compare_train_steps``' bars."""
    import numpy as np

    from patchrefinerv2_torch.models.patchrefiner import PatchRefiner
    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    da2 = dict(type="DA2", model_cfg=dict(encoder="vitt", features=64))
    plus = dict(TINY_ZOE, image_raw_shape=[112, 168], patch_process_shape=[56, 84], coarse_branch=da2,
                e2e_training=True, remat=True,
                refiner=dict(TINY_REFINER, fusion_model=dict(type="BiDirectionalFusion",
                                                             coarse_chl=[32, 64, 64, 64, 64, 64])))
    v1 = dict(TINY_V1, image_raw_shape=[112, 168], patch_process_shape=[56, 84], coarse_branch=da2,
              refiner=dict(TINY_V1["refiner"], fine_branch=da2))
    rng = np.random.RandomState(5)
    batch = dict(image_lr=rng.rand(2, 56, 84, 3).astype(np.float32),
                 crops_image_hr=rng.rand(2, 56, 84, 3).astype(np.float32),
                 crop_depths=(1.0 + 20.0 * rng.rand(2, 72, 96, 1)).astype(np.float32),
                 bboxs=np.array([[0.0, 0.0, 42.0, 28.0], [21.0, 14.0, 63.0, 42.0]], np.float32))
    for label, cls, cfg in (("tiny_da2_stage3", PatchRefinerPlus, plus), ("tiny_da2_v1", PatchRefiner, v1)):
        out = []
        for d in (dev, "cpu"):
            m = cls(cfg, device=d, seed=3).train()
            out.append(_step_result(m, m.loss(batch, update_stats=True)[0]))
        compare_train_steps(f"{label}_gpu_vs_cpu", *out)


def tiny_tester_gpu_vs_cpu(dev) -> None:
    """``Tester.run_consistency`` and ``model_complexity`` of the tiny flagship
    topology (``TINY_ZOE``, seed 3) on the card against the CPU: the error
    over one consistency-mode synthetic 96x128 frame (16 crops of 24x32
    overlapping by 8, at 48x64; process_num 4) within rel 1e-4 / abs 1e-5
    (the bar the CPU tests hold the port to JAX), each chunk's depth within
    1e-4 of its largest value (``small_gpu_vs_cpu``'s bar; the largest
    difference printed), and the FLOPs of an m1 frame and the parameters
    equal."""
    import math

    import torch

    from patchrefinerv2_torch.datasets.base import DataLoader
    from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
    from patchrefinerv2_torch.evaluation.tester import Tester
    from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus

    ds = SyntheticDataset(mode="train", consistency=True, length=1, image_raw_shape=(96, 128),
                          network_process_size=(48, 64), patch_raw_shape=(24, 32), overlap=8)
    out, depths = {}, {}
    for d in (dev, "cpu"):
        model = PatchRefinerPlus(TINY_ZOE, device=d, seed=3)
        loss, depths[str(d)] = model.loss, []
        model.loss = lambda *a, _l=loss, _d=depths[str(d)], **k: (
            lambda r: _d.append(r[1]["depth_pred"].float().cpu()) or r)(_l(*a, **k))
        tester = Tester({}, model, DataLoader(ds))
        out[str(d)] = dict(consistency=tester.run_consistency(process_num=4)["consistency"],
                           m1=tester.model_complexity((1, 48, 64, 3), (1, 96, 128, 3), "m1", 4))
    got, ref = out[str(dev)], out["cpu"]
    depth_err = max(float((g - c).abs().max()) / float(c.abs().max())
                    for g, c in zip(depths[str(dev)], depths["cpu"]))
    log({"phase": "tiny_tester_gpu_vs_cpu", **out, "depth_max_err_over_max": depth_err,
         "depth_bitwise_equal": all(torch.equal(g, c) for g, c in zip(depths[str(dev)], depths["cpu"])),
         "consistency_rel": abs(got["consistency"] - ref["consistency"]) / ref["consistency"]})
    if not (math.isclose(got["consistency"], ref["consistency"], rel_tol=1e-4, abs_tol=1e-5)
            and depth_err <= 1e-4 and len(depths["cpu"]) == 4 and got["m1"] == ref["m1"]):
        raise AssertionError(f"tiny Tester on the card {got} against the CPU {ref} (depth {depth_err})")


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


def timed(fn, *args):
    """``fn(*args)``, its host seconds logged: where the run's time goes."""
    t = time.time()
    out = fn(*args)
    log({"phase": "seconds", "of": fn.__name__, "args": [a for a in args if isinstance(a, str)],
         "s": time.time() - t})
    return out


def main() -> int:
    t_start = time.time()
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
    for check in (check_kernels, check_new_kernels, check_gate_tail, check_tail_conv, check_quant_conv,
                  check_v1_shapes, check_canny, check_semi_kernels):
        timed(check, chk, dev)
    timed(ranking_loss_on_edges, dev)
    timed(check_edge_cases, dev)
    plans = record_resize_plans()
    flagship_runs = timed(flagship, dev)
    m1_ms = flagship_runs.pop("m1_bfloat16_ms")
    counts = {**flagship_runs, **timed(depth_anything_v2, dev), **timed(cityscapes_eval, dev),
              **timed(mobile, dev), **timed(mobile_variants, dev), **timed(patchrefiner_v1, dev),
              **timed(cityscapes_eval, dev, "configs/patchrefiner_zoedepth/pr_cs.py", ("m1",), "v1_")}
    log({"phase": "resize_plans_of_the_main_paths",
         "channels_itemsize_vec_vstore_launches": sorted([*k, n] for k, n in plans.items())})
    timed(small_gpu_vs_cpu, dev)
    timed(eval_gpu_vs_cpu, dev)
    try:
        sites = timed(check_training_sites, chk, dev)
        log({"phase": "training_sites", **{path: {k: len(v) for k, v in s.items()}
                                          for path, s in sites.items()}})
        counts["train_f32"] = timed(pretrain_run, dev)
        timed(tiny_train_gpu_vs_cpu, dev)
        counts["train_e2e_f32"] = timed(stage3_run, dev)
        timed(tiny_stage3_gpu_vs_cpu, dev)
        # the mobile steps counted without their remat on/off timings and
        # profiled step, which keeps the run within its time limit
        counts["mobile_train_f32"] = timed(pretrain_run, dev, MOBILE_PRETRAIN_CONFIG, "mobile_pretrain",
                                           MOBILE_PRETRAINED, False)
        counts["mobile_train_e2e_f32"] = timed(stage3_run, dev, MOBILE_CONFIG, "mobile_stage3",
                                               MOBILE_PRETRAINED, False, False)
        timed(tiny_train_gpu_vs_cpu, dev, MOBILE_PRETRAIN_CONFIG, "tiny_mobile_train")
        counts["v1_train_f32"] = timed(v1_train_run, dev)
        timed(tiny_v1_train_gpu_vs_cpu, dev)
        for label, config in SEMI_CONFIGS.items():
            counts[f"{label}_f32"] = timed(semi_run, dev, label, config)
        timed(tiny_semi_gpu_vs_cpu, dev)
        counts.update(timed(data_run, dev, counts["m1"], counts["eval_m1"], counts["train_e2e_f32"], m1_ms))
        timed(tiny_tester_gpu_vs_cpu, dev)
        counts.update(timed(datasets_run, dev, counts["m1"]))
        counts.update(timed(baseline_run, dev))
        timed(tiny_baseline_gpu_vs_cpu, dev)
        counts.update(timed(da2_train_run, dev, chk))
        timed(tiny_da2_train_gpu_vs_cpu, dev)
    finally:
        import shutil

        shutil.rmtree(WORK_DIR, ignore_errors=True)

    kernels = []
    for name, k in ops.KERNELS.items():
        by_run = {run: c[name] for run, c in counts.items()}
        kernels.append(dict(
            name=name, route=k["route"], source=k["source"], replaces=k["replaces"],
            launches=sum(by_run.values()), launches_by_run=by_run, **chk.record(name)))
    log({"phase": "total", "seconds": time.time() - t_start})
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
