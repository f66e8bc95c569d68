"""Ops of the port: each hand-written Hopper kernel beside its plain PyTorch
version. ``KERNELS`` lists every kernel wrapper with its source and the
TPU-side function it replaces; ``reset_launches``/``launch_counts`` read the
wrappers' launch counters."""

from __future__ import annotations

from patchrefinerv2_torch.ops.attention import attention
from patchrefinerv2_torch.ops.bins import attractor_update, log_binomial_depth
from patchrefinerv2_torch.ops.blend import TileBlender
from patchrefinerv2_torch.ops.canny import canny_nms, hysteresis_bounded
from patchrefinerv2_torch.ops.gated import gate_tail
from patchrefinerv2_torch.ops.layer_norm import layer_norm
from patchrefinerv2_torch.ops.quant import quant_conv
from patchrefinerv2_torch.ops.resize import crop_resize, resize
from patchrefinerv2_torch.ops.roi_align import roi_align
from patchrefinerv2_torch.ops.tail_conv import tail_conv

KERNELS = {
    "roi_align": dict(wrapper=roi_align, route="cuda",
                      source="patchrefinerv2_torch/csrc/roi_align.cu",
                      replaces="patchrefinerv2_tpu/ops/roi_align.py:86"),
    "resize": dict(wrapper=resize, route="cuda",
                   source="patchrefinerv2_torch/csrc/resize.cu",
                   replaces="patchrefinerv2_tpu/ops/resize.py:214"),
    "crop_resize": dict(wrapper=crop_resize, route="cuda",
                        source="patchrefinerv2_torch/csrc/resize.cu",
                        replaces="patchrefinerv2_tpu/models/tiling.py:229"),
    "layer_norm": dict(wrapper=layer_norm, route="triton",
                       source="patchrefinerv2_torch/ops/layer_norm.py",
                       replaces="patchrefinerv2_tpu/models/blocks/convs.py:18"),
    "blend_add_pass": dict(wrapper=TileBlender.add_pass, route="cuda",
                           source="patchrefinerv2_torch/csrc/blend.cu",
                           replaces="patchrefinerv2_tpu/ops/blend.py:54"),
    "blend_finalize": dict(wrapper=TileBlender.finalize, route="cuda",
                           source="patchrefinerv2_torch/csrc/blend.cu",
                           replaces="patchrefinerv2_tpu/ops/blend.py:113"),
    "attention": dict(wrapper=attention, route="cuda",
                      source="patchrefinerv2_torch/csrc/attention.cu",
                      replaces="patchrefinerv2_tpu/models/backbones/beit.py:46 (K3), "
                               "patchrefinerv2_tpu/ops/attention.py:44 (K4)"),
    "gate_tail": dict(wrapper=gate_tail, route="cuda",
                      source="patchrefinerv2_torch/csrc/gated_conv.cu",
                      replaces="patchrefinerv2_tpu/models/blocks/dpt.py:96"),
    "attractor_update": dict(wrapper=attractor_update, route="cuda",
                             source="patchrefinerv2_torch/csrc/bins.cu",
                             replaces="patchrefinerv2_tpu/models/backbones/zoedepth.py:117,149 "
                                      "(with _interp :124,159)"),
    "log_binomial_depth": dict(wrapper=log_binomial_depth, route="cuda",
                               source="patchrefinerv2_torch/csrc/bins.cu",
                               replaces="patchrefinerv2_tpu/models/backbones/zoedepth.py:186 "
                                        "(with _interp :375-376)"),
    "canny_nms": dict(wrapper=canny_nms, route="cuda",
                      source="patchrefinerv2_torch/csrc/canny.cu",
                      replaces="patchrefinerv2_tpu/ops/canny.py:14"),
    "hysteresis_bounded": dict(wrapper=hysteresis_bounded, route="cuda",
                               source="patchrefinerv2_torch/csrc/hysteresis.cu",
                               replaces="patchrefinerv2_tpu/models/losses_extra.py:129-134 "
                                        "(with _dilate3x3 :81)"),
    "tail_conv": dict(wrapper=tail_conv, route="cuda",
                      source="patchrefinerv2_torch/csrc/tail_conv.cu",
                      replaces="patchrefinerv2_tpu/ops/s2d.py:114,139,156,190,198"),
    "quant_conv": dict(wrapper=quant_conv, route="cuda",
                       source="patchrefinerv2_torch/csrc/quant_conv.cu",
                       replaces="patchrefinerv2_tpu/ops/quant.py:130,154,218"),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}
