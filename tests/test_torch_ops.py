"""The port's ops (plain PyTorch versions of the K1, K2, K6, K7 kernels and
the host-side tile plan) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the port
runs on CPU tensors, so every kernel wrapper takes its plain version.
Float32 throughout. Tolerances: atol 1e-5 / rtol 1e-5 where both sides
compute the same float32 arithmetic in another order (the JAX ops
contract dense weight matrices, the port gathers the same taps); blending
is held exactly where it only adds in the same order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patchrefinerv2_tpu.models import tiling as jtiling
from patchrefinerv2_tpu.models.blocks.convs import DotLayerNorm
from patchrefinerv2_tpu.models.blocks.dpt import _layer_norm
from patchrefinerv2_tpu.ops.blend import TileBlender as JBlender
from patchrefinerv2_tpu.ops.masks import generate_blend_mask as j_mask
from patchrefinerv2_tpu.ops.resize import resize as j_resize
from patchrefinerv2_tpu.ops.roi_align import roi_align as j_roi_align

from patchrefinerv2_torch.models import tiling as ttiling
from patchrefinerv2_torch.ops.blend import TileBlender
from patchrefinerv2_torch.ops.layer_norm import layer_norm
from patchrefinerv2_torch.ops.masks import generate_blend_mask
from patchrefinerv2_torch.ops.resize import axis_taps, crop_resize, resize
from patchrefinerv2_torch.ops.roi_align import roi_align

T = torch.from_numpy


# ---------------------------------------------------------------- K1
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roi_align_random_boxes_cross_border(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 12, 16, 5).astype(np.float32)
    boxes = []
    for _ in range(8):  # some boxes start left/above of the map or end past it
        x1, y1 = rng.uniform(-60, 450), rng.uniform(-60, 330)
        boxes.append([x1, y1, x1 + rng.uniform(10, 260), y1 + rng.uniform(10, 200)])
    boxes = np.array(boxes, np.float32)
    idx = rng.randint(0, 2, size=8).astype(np.int32)
    scale = 12 / 384.0
    ref = np.asarray(j_roi_align(feats, boxes, idx, (12, 16), scale))
    got = roi_align(T(feats), T(boxes), T(idx), (12, 16), scale).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_roi_align_call_site_geometry():
    """coarse_postprocess geometry (tests/test_roi_align.py:32): output size
    = feature size, scale = h_feat / 384, boxes of a 2x2 split of a 4K frame
    in process coordinates."""
    rng = np.random.RandomState(3)
    feats = rng.randn(1, 24, 32, 8).astype(np.float32)
    boxes = np.array([[ws * 512 / 3840, hs * 384 / 2160, (ws + 1920) * 512 / 3840,
                       (hs + 1080) * 384 / 2160] for hs in (0, 1080) for ws in (0, 1920)],
                     np.float32)
    idx = np.zeros(4, np.int32)
    ref = np.asarray(j_roi_align(feats, boxes, idx, (24, 32), 24 / 384.0))
    got = roi_align(T(feats), T(boxes), T(idx), (24, 32), 24 / 384.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_roi_align_border_rule():
    """Samples at y < -1 give 0, samples in [-1, 0) clamp to row 0, samples
    in (H-1, H] clamp to row H-1 and samples past H give 0 (the same along
    x). Boxes of height and width 2 on an 8x8 output put samples 0.25
    apart across each of those bands."""
    rng = np.random.RandomState(8)
    feats = rng.randn(1, 8, 8, 3).astype(np.float32)
    # shifted (box - 0.5) origins -1.25, 7.0 and 7.875: samples -1.125 ... 0.625,
    # 7.125 ... 8.875 and 8.0 (exactly H, still valid) ... 9.75
    boxes = np.array([[-0.75, -0.75, 1.25, 1.25], [7.5, 7.5, 9.5, 9.5],
                      [-0.75, 7.5, 1.25, 9.5], [7.5, -0.75, 9.5, 1.25],
                      [8.375, 8.375, 10.375, 10.375]], np.float32)
    idx = np.zeros(5, np.int32)
    ref = np.asarray(j_roi_align(feats, boxes, idx, (8, 8), 1.0))
    got = roi_align(T(feats), T(boxes), T(idx), (8, 8), 1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (ref[0, 0] == 0).all() and (ref[1, -1] == 0).all()  # the zero bands are there
    assert (ref[0, 1:, 1:] != 0).all() and (ref[4, 0, 0] != 0).all()


def test_roi_align_rejects_other_sampling_ratios():
    f = torch.zeros(1, 4, 4, 1)
    with pytest.raises(NotImplementedError):
        roi_align(f, torch.zeros(1, 4), torch.zeros(1, dtype=torch.int32), (2, 2), 1.0, 2)


# ---------------------------------------------------------------- K2
@pytest.mark.parametrize("mode,ac", [("bilinear", True), ("bilinear", False), ("nearest", False)])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (16, 20)), ((24, 32), (12, 16)),
                                          ((13, 17), (13, 40)), ((96, 128), (384, 512))])
def test_resize_matches_jax(mode, ac, in_hw, out_hw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(x), out_hw, mode, ac))
    got = resize(T(x), out_hw, mode, ac).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_resize_rejects_bicubic():
    """Bicubic is ported (four taps per axis); modes the JAX package does not
    have still raise."""
    idx, w = axis_taps(4, 8, "bicubic", False)
    assert idx.shape == w.shape == (4, 8)
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        resize(torch.zeros(1, 4, 4, 1), (8, 8), "area")


@pytest.mark.parametrize("in_hw,out_hw,scale", [
    ((37, 37), (32, 32), ((32 + 0.1) / 37, (32 + 0.1) / 37)),  # the DINOv2 pos-embed quirk
    ((37, 37), (24, 32), ((24 + 0.1) / 37, (32 + 0.1) / 37)),
    ((7, 9), (16, 20), None),
    ((13, 17), (6, 40), None),
])
def test_bicubic_resize_matches_jax(in_hw, out_hw, scale):
    rng = np.random.RandomState(9)
    x = rng.randn(1, *in_hw, 5).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(x), out_hw, "bicubic", False, scale_override=scale))
    got = resize(T(x), out_hw, "bicubic", False, scale_override=scale).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("raw,split,proc", [((96, 128), (2, 2), (40, 56)),
                                            ((90, 160), (2, 4), (64, 48))])
def test_crop_resize_matches_jax(raw, split, proc):
    rng = np.random.RandomState(1)
    img = rng.rand(*raw, 3).astype(np.float32)
    cfg = jtiling.TileCfg(raw, split, proc)
    p = jtiling.regular_pass(cfg, (1, 1), 4)
    ref = np.asarray(jtiling.crop_resize_patches(jnp.asarray(img), jnp.asarray(p.starts_raw),
                                                 cfg.patch_raw_shape, proc))
    got = crop_resize(T(img), T(p.starts_raw), cfg.patch_raw_shape, proc).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("shape", [(3, 5, 7, 32), (769, 64), (2, 6, 256)])
def test_layer_norm_matches_dot_layer_norm_and_layer_norm(shape):
    rng = np.random.RandomState(2)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    dot = np.asarray(DotLayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    lnf = np.asarray(_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = layer_norm(T(x), T(scale), T(bias), 1e-6).numpy()
    np.testing.assert_allclose(got, dot, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, lnf, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- K7
def _blend_both(passes, shape, mask, init_flags, valid=None, initv=None):
    jst = JBlender.init(shape)
    tst = TileBlender.init(shape, "cpu")
    for (preds, starts), init in zip(passes, init_flags):
        kw = {}
        if valid is not None:
            kw["valid"] = valid
        if initv is not None:
            kw["initv"] = initv
        jst = JBlender.add_pass(jst, jnp.asarray(preds), jnp.asarray(mask), jnp.asarray(starts),
                                init_pass=init, **{k: jnp.asarray(v) for k, v in kw.items()})
        tst = TileBlender.add_pass(tst, T(preds), T(mask), T(starts), init_pass=init,
                                   **{k: T(v) for k, v in kw.items()})
    return jst, tst


def test_blend_multi_pass_overlap_matches_jax():
    rng = np.random.RandomState(4)
    h, w = 8, 10
    mask = j_mask((h, w), 0.15)
    p0 = (rng.rand(4, h, w).astype(np.float32), np.array([[0, 0], [0, 10], [8, 0], [8, 10]], np.int32))
    p1 = (rng.rand(3, h, w).astype(np.float32), np.array([[4, 5], [0, 5], [4, 0]], np.int32))
    p2 = (rng.rand(2, h, w).astype(np.float32), np.array([[3, 3], [5, 7]], np.int32))
    jst, tst = _blend_both([p0, p1, p2], (16, 20), mask, [True, False, False])
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(TileBlender.finalize(tst).numpy(),
                                  np.asarray(JBlender.finalize(jst)))


def test_blend_pure_m1_returns_mosaic():
    """A pure m1 run returns the unweighted mosaic (tests/test_masks_blend.py:100)."""
    rng = np.random.RandomState(5)
    preds = rng.rand(4, 6, 8).astype(np.float32)
    starts = np.array([[0, 0], [0, 8], [6, 0], [6, 8]], np.int32)
    mask = j_mask((6, 8), 0.15)
    jst, tst = _blend_both([(preds, starts)], (12, 16), mask, [True])
    out = TileBlender.finalize(tst).numpy()
    np.testing.assert_array_equal(out, np.asarray(JBlender.finalize(jst)))
    # where the mask is 0 the mosaic itself, elsewhere (p * m) / m, within rounding of p
    np.testing.assert_allclose(out, np.block([[preds[0], preds[1]], [preds[2], preds[3]]]),
                               rtol=1e-6, atol=0)


def test_blend_per_patch_init_and_valid_match_jax():
    rng = np.random.RandomState(6)
    preds = rng.rand(6, 6, 8).astype(np.float32)
    starts = np.array([[0, 0], [0, 8], [3, 4], [6, 0], [6, 8], [6, 8]], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0], np.float32)
    initv = np.array([1, 1, 0, 1, 1, 0], np.float32)
    mask = j_mask((6, 8), 0.15)
    jst, tst = _blend_both([(preds, starts)], (12, 16), mask, [False], valid=valid, initv=initv)
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_blend_resize_matches_jax():
    rng = np.random.RandomState(7)
    preds = rng.rand(4, 6, 8).astype(np.float32)
    starts = np.array([[0, 0], [0, 8], [6, 0], [3, 4]], np.int32)
    mask = j_mask((6, 8), 0.15)
    jst, tst = _blend_both([(preds, starts)], (12, 16), mask, [False])
    jr = JBlender.resize(jst, (30, 41))
    tr = TileBlender.resize(tst, (30, 41))
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("size,border", [((384, 512), 0.15), ((540, 960), 0.15), ((48, 64), 0.1)])
def test_blend_mask_matches_jax(size, border):
    np.testing.assert_array_equal(generate_blend_mask(size, border), j_mask(size, border))


@pytest.mark.parametrize("raw,split,proc,pn", [((2160, 3840), (4, 4), (384, 512), 16),
                                               ((96, 128), (2, 2), (48, 64), 4),
                                               ((100, 150), (3, 2), (30, 40), 5)])
def test_tile_plans_match_jax(raw, split, proc, pn):
    jc, tc = jtiling.TileCfg(raw, split, proc), ttiling.TileCfg(raw, split, proc)
    assert tc.patch_raw_shape == jc.patch_raw_shape
    assert tc.patch_reensemble_shape == jc.patch_reensemble_shape
    offs = ((0, 0), (0, 1), (1, 0), (1, 1))
    jp = [jtiling.regular_pass(jc, o, pn) for o in offs]
    tp = [ttiling.regular_pass(tc, o, pn) for o in offs]
    for a, b in zip(tp, jp):
        assert a.n_valid == b.n_valid
        for f in ("starts_raw", "starts_process", "bboxes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    chunk = min(pn, ttiling._BATCH_GRANULE)
    assert chunk == min(pn, jtiling._BATCH_GRANULE)
    (ts, tiv), (js, jiv) = ttiling.merge_all_passes(tp, chunk), jtiling.merge_all_passes(jp, chunk)
    np.testing.assert_array_equal(tiv, jiv)
    assert ts.n_valid == js.n_valid
    for f in ("starts_raw", "starts_process", "bboxes"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
