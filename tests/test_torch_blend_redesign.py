"""What the redesigned K7 add_pass (``csrc/blend.cu``: a block per canvas
tile, over the patches that overlap it, listed in patch order) promises,
pinned on the CPU, where the kernel cannot run.

A numpy model of the kernel's culling: per canvas tile of ``TILE`` pixels,
the first warp's pre-pass (does any patch overlap the tile, and any init
patch), then the list in pieces (32 patches a ballot step, whole steps
while they fit ``LIST_CAP``), then each listed patch's pixels of the tile
in list order with float32 products and sums, the canvases loaded on a
pixel's first cover, the mosaic only in tiles with an init patch. It must
equal ``add_pass_plain`` bit for bit on the m1, m2 and r32 starts of the
flagship frame, on a canvas whose width is not a multiple of 4, and with
more overlapping patches than a list holds. The tile and list capacity
are read from the kernel's source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from patchrefinerv2_torch.models.tiling import (
    TileCfg, merge_all_passes, random_pass_starts, regular_pass,
)
from patchrefinerv2_torch.ops import blend
from patchrefinerv2_torch.ops.blend import BlendState, add_pass_plain
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

SRC = (Path(blend.__file__).resolve().parent.parent / "csrc" / "blend.cu").read_text()


def test_tile_and_capacity_match_the_kernel():
    m = re.search(r"constexpr int TW = (\d+), TH = (\d+), THREADS = (\d+), ROWS = TH / \(THREADS / 32\), "
                  r"LIST_CAP = (\d+);", SRC)
    tw, th, threads, cap = map(int, m.groups())
    assert blend.TILE == (th, tw) and blend.LIST_CAP == cap
    # a thread's 4 pixels of a row, a warp 128 pixels, every row of the tile covered
    assert tw == 4 * 32 and th % (threads // 32) == 0


def overlaps(sy, sx, h, w, ty0, tx0, th, tw):
    return sy < ty0 + th and sy + h > ty0 and sx < tx0 + tw and sx + w > tx0


def pieces(starts, h, w, ty0, tx0, th, tw, cap):
    """The lists the first warp builds for a tile: 32 patches a ballot
    step, whole steps while the list has room, in patch order."""
    n, k0, out = len(starts), 0, []
    while True:
        lst, k = [], k0
        while k < n:
            step = [kk for kk in range(k, min(k + 32, n))
                    if overlaps(*starts[kk], h, w, ty0, tx0, th, tw)]
            if len(lst) + len(step) > cap:
                assert lst  # a list holds a whole ballot step: cap >= 32
                break
            lst += step
            k += 32
        out.append(lst)
        if k >= n:
            return out
        k0 = k


def model(state, preds, mask, starts, valid, initv, tile=blend.TILE, cap=blend.LIST_CAP):
    """The add_pass kernel over numpy float32 canvases (updated in place)."""
    mosaic, swp, sw = state
    rh, rw = sw.shape
    n, h, w = preds.shape
    th, tw = tile
    starts = [tuple(map(int, s)) for s in starts]
    listed = 0
    for ty0 in range(0, rh, th):
        for tx0 in range(0, rw, tw):
            cover = [k for k in range(n) if overlaps(*starts[k], h, w, ty0, tx0, th, tw)]
            if not cover:
                continue
            has_init = any(initv[k] > 0 for k in cover)
            y1, x1 = min(ty0 + th, rh), min(tx0 + tw, rw)
            a, b, mo = (c[ty0:y1, tx0:x1].copy() for c in (swp, sw, mosaic))
            touched = np.zeros(a.shape, bool)
            seen = []
            for lst in pieces(starts, h, w, ty0, tx0, th, tw, cap):
                assert len(lst) <= cap
                seen += lst
                for k in lst:
                    sy, sx = starts[k]
                    ys, ye = max(sy, ty0), min(sy + h, y1)
                    xs, xe = max(sx, tx0), min(sx + w, x1)
                    if ys >= ye or xs >= xe:
                        continue
                    p = preds[k, ys - sy:ye - sy, xs - sx:xe - sx].astype(np.float32)
                    m = mask[ys - sy:ye - sy, xs - sx:xe - sx] * np.float32(valid[k])
                    sl = (slice(ys - ty0, ye - ty0), slice(xs - tx0, xe - tx0))
                    a[sl] = a[sl] + p * m
                    b[sl] = b[sl] + m
                    if initv[k] > 0:
                        mo[sl] = p
                    touched[sl] = True
            assert seen == cover  # every overlapping patch once, in patch order
            listed += len(seen)
            swp[ty0:y1, tx0:x1][touched] = a[touched]
            sw[ty0:y1, tx0:x1][touched] = b[touched]
            if has_init:
                mosaic[ty0:y1, tx0:x1][touched] = mo[touched]
    return listed


def run_both(canvas, starts, h, w, initv, seed, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    n = len(starts)
    preds = torch.from_numpy((rng.rand(n, h, w) * 10).astype(np.float32)).to(dtype)
    mask = rng.rand(h, w).astype(np.float32) + np.float32(1e-3)
    valid = (rng.rand(n) > 0.1).astype(np.float32)
    initv = np.asarray(initv, np.float32)
    sum_w = rng.rand(*canvas).astype(np.float32)
    avg = (rng.rand(*canvas) * 10).astype(np.float32)
    base = [avg, avg * sum_w, sum_w]
    ref = BlendState(*(torch.from_numpy(c.copy()) for c in base))
    add_pass_plain(ref, preds, torch.from_numpy(mask), torch.from_numpy(np.asarray(starts, np.int32)),
                   torch.from_numpy(valid), torch.from_numpy(initv))
    got = [c.copy() for c in base]
    listed = model(got, preds.float().numpy(), mask, starts, valid, initv)
    for name, g_, r_ in zip(BlendState._fields, got, ref):
        assert np.array_equal(g_.view(np.int32), r_.numpy().view(np.int32)), name
    return listed


TC = TileCfg((2160, 3840), (4, 4), (384, 512))


def m2_stream(chunk):
    passes = [regular_pass(TC, off, 16) for off in ((0, 0), (0, 1), (1, 0), (1, 1))]
    return merge_all_passes(passes, chunk)


@pytest.mark.parametrize("case", ["m1", "m2_chunk", "m2_all49", "r32_raw"])
def test_culled_lists_equal_add_pass_plain(case):
    h, w = TC.patch_process_shape
    canvas = TC.patch_reensemble_shape
    if case == "m1":
        starts, initv = regular_pass(TC, (0, 0), 16).starts_process, np.ones(16)
    elif case == "m2_chunk":  # the chunk that straddles the init pass and the first shifted pass
        stream, initv = m2_stream(8)
        starts, initv = stream.starts_process[8:16], initv[8:16]
    elif case == "m2_all49":  # every m2 patch in one list (process_num 49)
        stream, initv = m2_stream(49)
        starts = stream.starts_process
        assert len(starts) == 49
    else:  # a random chunk of r32 on the raw canvas: one shared w start
        starts = random_pass_starts(torch.Generator().manual_seed(5), TC, 16)
        h, w = TC.patch_raw_shape
        canvas, initv = TC.image_raw_shape, np.zeros(16)
    # downscale the canvas 4x so that the model stays quick: the starts, the
    # patch and the canvas together, which keeps every overlap
    starts = np.asarray(starts) // 4
    listed = run_both((canvas[0] // 4, canvas[1] // 4), starts, h // 4, w // 4, initv, seed=len(case))
    assert listed > 0


def test_more_patches_than_a_list_holds():
    """130 patches over the same place, every one overlapping each tile it
    touches: 5 pieces of whole ballot steps (32, 32, 32, 32, 2), bit for
    bit; and 70 scattered patches, whose steps fill the list unevenly."""
    starts = [(5, 11)] * 130
    initv = (np.arange(130) % 3 == 0)
    assert [len(p) for p in pieces(starts, 40, 200, 0, 0, *blend.TILE, blend.LIST_CAP)] == [32, 32, 32, 32, 2]
    run_both((64, 300), starts, 40, 200, initv, seed=1, dtype=torch.float32)
    rng = np.random.RandomState(2)
    starts = np.stack([rng.randint(0, 40, 70), rng.randint(0, 100, 70)], 1)
    assert len(pieces(starts, 20, 180, 0, 0, *blend.TILE, blend.LIST_CAP)) >= 2
    run_both((64, 300), starts, 20, 180, rng.randint(0, 2, 70), seed=3)


def test_odd_width_and_seams():
    """A canvas width that is not a multiple of 4 (the kernel's scalar
    path) and patches that start on a tile seam, end on one, or reach the
    canvas edge."""
    th, tw = blend.TILE
    rng = np.random.RandomState(0)
    starts = np.concatenate([rng.randint(0, 30, (20, 2)) * [1, 9],
                             [[th - 7, tw - 29], [th - 3, tw], [0, 0], [37 - 7, 301 - 29]]])
    run_both((37, 301), starts, 7, 29, rng.randint(0, 2, len(starts)), seed=4, dtype=torch.float32)
