"""What the redesigned K1 (``csrc/roi_align.cu``: one block per box and band
of output rows, taps computed once, 16-byte vectors) promises, pinned on the
CPU, where the kernel cannot run.

(a) The kernel's tap arithmetic, modelled in numpy float32 step by step
(each operation rounded, as the kernel's ``__fdiv_rn`` / ``__fmul_rn`` /
``__fadd_rn`` / ``__fsub_rn``), gives the row and column taps of the plain
version's ``_axis_taps`` exactly, at the 7 levels of the flagship, DA2 and
Cityscapes paths, for the boxes of their m1 and shifted m2 chunks.

(b) The vector plan (``ops/roi_align.launch_plan``) at every level: 16-byte
channel vectors at the 256-, 128- and 32-channel levels, column vectors at
the 1-channel coarse depth, one element a thread where neither fits, and
bands of ~32 KB of output.

(c) The port against ``patchrefinerv2_tpu.ops.roi_align.roi_align`` at each
level's channel count, on small maps with the call site's geometry (output
size = map size, scale = h / process height), float32: max |port - JAX|
<= 1e-5 of max |JAX| (the float32 bar of ``chip_smoke.tol_of``: the JAX
side contracts one-hot matrices, the port gathers the same taps, and the
sums differ in their last bits).
"""

import numpy as np
import pytest
import torch

from patchrefinerv2_tpu.ops.roi_align import roi_align as j_roi_align

from patchrefinerv2_torch.models.tiling import TileCfg, regular_pass
from patchrefinerv2_torch.ops.roi_align import _axis_taps, launch_plan, roi_align
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

FLAGSHIP = [(12, 16, 256), (24, 32, 256), (48, 64, 256), (96, 128, 256), (192, 256, 256),
            (384, 512, 32), (384, 512, 1)]
PATHS = {
    "flagship": ((2160, 3840), (384, 512), FLAGSHIP),
    "da2": ((2160, 3840), (448, 448), [(16, 16, 256), (32, 32, 256), (64, 64, 256), (128, 128, 256),
                                       (256, 256, 256), (448, 448, 128), (448, 448, 1)]),
    "cityscapes_eval": ((1024, 2048), (384, 512), FLAGSHIP),
}


def kernel_taps(lo, hi, out_size, in_size):
    """``taps`` of ``csrc/roi_align.cu`` for samples 0 .. out_size - 1 of one
    box, one rounded float32 operation at a time."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    bin_ = f32(f32(hi - lo) / f32(out_size))
    i0s, i1s, w0s, w1s = [], [], [], []
    for i in range(out_size):
        v = f32(lo + f32(f32(f32(i) + f32(0.5)) * bin_))
        valid = f32(-1.0) <= v <= f32(in_size)
        vc = min(max(v, f32(0.0)), f32(in_size - 1))
        fl = f32(np.floor(vc))
        fr = f32(vc - fl)
        i0 = int(fl)
        i0s.append(i0)
        i1s.append(min(i0 + 1, in_size - 1))
        w0s.append(f32(f32(1.0) - fr) if valid else f32(0.0))
        w1s.append(fr if valid else f32(0.0))
    return np.array(i0s), np.array(i1s), np.array(w0s, np.float32), np.array(w1s, np.float32)


def chunk_boxes(frame, process):
    """The m1 chunk's 16 boxes and a shifted m2 pass's (half-patch offsets)."""
    tc = TileCfg(frame, (4, 4), process)
    return np.concatenate([regular_pass(tc, (0, 0), 16).bboxes, regular_pass(tc, (1, 1), 16).bboxes])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_kernel_taps_equal_axis_taps(path):
    frame, (pph, ppw), levels = PATHS[path]
    boxes = chunk_boxes(frame, (pph, ppw))
    for h, w, _ in levels:
        scale = np.float32(h / pph)
        bx = torch.from_numpy(boxes).float() * float(h / pph) - 0.5
        k = boxes * scale  # the kernel: box * scale, then - 0.5, each rounded
        k = (k.astype(np.float32) - np.float32(0.5)).astype(np.float32)
        np.testing.assert_array_equal(k, bx.numpy())
        for axis, size, out in ((1, h, h), (0, w, w)):
            ref = _axis_taps(bx[:, axis], bx[:, axis + 2], out, size)
            for b in range(len(boxes)):
                got = kernel_taps(k[b, axis], k[b, axis + 2], out, size)
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g, r[b].numpy())


@pytest.mark.parametrize("itemsize", [2, 4])
def test_vector_plan_per_level(itemsize):
    vec = 16 // itemsize
    for _, (_, _, levels) in PATHS.items():
        for h, w, c in levels:
            p = launch_plan(c, h, w, itemsize)
            assert p["mode"] == ("columns" if c == 1 else "channels") and p["vec"] == vec
            row = w * c * itemsize
            assert p["band"] == max(1, min(h, 32 * 1024 // row))
            assert p["blocks"] * p["band"] >= h > (p["blocks"] - 1) * p["band"]
    assert launch_plan(5, 12, 16, 4)["mode"] == "scalar"
    assert launch_plan(1, 12, 10, 2)["mode"] == "scalar"  # 10 columns: no 8-wide column vector
    assert launch_plan(256, 12, 16, 2, aligned=False)["mode"] == "scalar"


@pytest.mark.parametrize("path", sorted(PATHS))
def test_port_matches_jax_at_each_level_channel_count(path):
    """Small maps (the level's channels, its size divided by a power of two
    up to 8, at least 6 rows, so that the map keeps the process shape's
    aspect as at the call site) with the call site's geometry; the m1
    chunk's boxes and a shifted pass's, all of one image."""
    frame, (pph, ppw), levels = PATHS[path]
    boxes = chunk_boxes(frame, (pph, ppw))
    rng = np.random.RandomState(len(path))
    for h, w, c in levels:
        d = 1 << int(np.log2(max(1, min(8, h // 6))))
        sh, sw = h // d, w // d
        feats = rng.randn(1, sh, sw, c).astype(np.float32)
        idx = np.zeros(len(boxes), np.int32)
        ref = np.asarray(j_roi_align(feats, boxes, idx, (sh, sw), sh / pph))
        got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), torch.from_numpy(idx),
                        (sh, sw), sh / pph).numpy()
        assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0), (h, w, c)
