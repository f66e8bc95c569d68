"""K11 (canny non-maximum suppression) and the port's canny edges against the
JAX package on the CPU, where ``canny_nms`` and ``canny_nms_masks`` take
their plain versions.

- ``canny_nms_plain`` against the JAX ``canny_nms`` over numpy and over
  ``jax.numpy`` (64-bit) on seeded gradients with exact ties (small integer
  gradients, constant magnitudes, pure axis and diagonal directions) and
  zero gradients: the masks are equal in float64 (and in float32 against
  numpy), since the plain version does the reference's operations in its
  order.
- ``canny_nms_masks_plain`` against the JAX ``canny_nms`` followed by the
  two callers' epilogues, the loss's (``models/losses_extra.py:125-128``,
  the 1-pixel interior) and the evaluation's (``evaluation/metrics.py:107-110``,
  the eroded mask): equal masks in float64 and float32.
- ``walk_model``: the kernel of ``csrc/canny.cu`` in numpy, warp by warp
  (column strips of 32 V pixels, row bands of R rows, the rolling
  three-row window, neighbours shuffled from the adjacent lanes and loaded
  by the edge lanes, zeros outside the map, the vector path and the scalar
  path, both modes), its constants read from the source; every pixel
  written once and the masks equal to the plain versions' at widths and
  heights either side of each strip and band, on ties and at magnitudes
  equal to a threshold, with and without a mask.
- ``extract_edges`` (log and inverse preprocessing) and ``canny`` (with and
  without a mask, other thresholds) against ``extract_edges`` /
  ``_canny_numpy`` on seeded 64x96 depth maps: the masks are equal. The
  smoothing and the Sobel gradients follow scipy's order of operations, and
  the hysteresis is exact (the 8-connected components of the low mask that
  hold a high pixel).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import ndimage as ndi

from patchrefinerv2_tpu.evaluation import metrics as jmetrics
from patchrefinerv2_tpu.ops.canny import canny_nms as j_canny_nms

from patchrefinerv2_torch.evaluation import metrics
from patchrefinerv2_torch.ops import canny as canny_ops
from patchrefinerv2_torch.ops.canny import (
    NMS_ROWS, canny_nms, canny_nms_masks, canny_nms_masks_plain, canny_nms_plain, canny_nms_plan,
)
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)


def gradients(kind: str, seed: int, shape=(64, 96)):
    """(isobel, jsobel, magnitude) float64 numpy maps."""
    rng = np.random.RandomState(seed)
    if kind == "normal":
        gi, gj = rng.randn(*shape), rng.randn(*shape)
    elif kind == "integer":  # many exact ties between neighbours and sectors
        gi = rng.randint(-2, 3, shape).astype(np.float64)
        gj = rng.randint(-2, 3, shape).astype(np.float64)
    else:  # smooth gradients with patches of zeros, pure directions and flat magnitude
        f = ndi.gaussian_filter(rng.rand(*shape), 2) * 10
        gi, gj = ndi.sobel(f, 0), ndi.sobel(f, 1)
        gi[:10, :20] = 0.0
        gj[:10, :20] = 0.0
        gi[20:30, 10:40] = 0.0  # pure horizontal gradients
        gj[30:40, 40:70] = 0.0  # pure vertical
        gj[40:50, :30] = gi[40:50, :30]  # diagonal, |i| == |j|
        gj[50:60, 50:90] = -gi[50:60, 50:90]
    mag = np.hypot(gi, gj)
    if kind == "smooth":
        mag[5:25, 60:90] = 1.5  # ties with every neighbour
    return gi, gj, mag


@pytest.mark.parametrize("kind,seed", [("normal", 0), ("integer", 1), ("integer", 2), ("smooth", 3)])
def test_canny_nms_plain_matches_jax(kind, seed):
    gi, gj, mag = gradients(kind, seed)
    t = [torch.from_numpy(a) for a in (gi, gj, mag)]
    got = canny_nms_plain(*t).numpy()
    assert got.dtype == np.bool_ and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, j_canny_nms(np, gi, gj, mag))
    with jax.enable_x64(True):
        ref_j = np.asarray(j_canny_nms(jnp, *(jnp.asarray(a) for a in (gi, gj, mag))))
    np.testing.assert_array_equal(got, ref_j)
    # float32 against numpy float32; the wrapper on CPU tensors is the plain version
    g32 = [a.astype(np.float32) for a in (gi, gj, mag)]
    got32 = canny_nms(*(torch.from_numpy(a) for a in g32)).numpy()
    np.testing.assert_array_equal(got32, j_canny_nms(np, *g32))


def test_canny_nms_batched_and_one_pixel_wide():
    gi, gj, mag = gradients("normal", 4, (3, 17, 1))
    ref = j_canny_nms(np, gi, gj, mag)
    np.testing.assert_array_equal(canny_nms_plain(*map(torch.from_numpy, (gi, gj, mag))).numpy(), ref)
    gi, gj, mag = (a.transpose(0, 2, 1).copy() for a in (gi, gj, mag))
    np.testing.assert_array_equal(canny_nms_plain(*map(torch.from_numpy, (gi, gj, mag))).numpy(),
                                  j_canny_nms(np, gi, gj, mag))
    with pytest.raises(ValueError, match="one shape"):
        canny_nms(*map(torch.from_numpy, (gi, gj[:, :, :1], mag)))


SOURCE = (Path(canny_ops.__file__).parents[1] / "csrc" / "canny.cu").read_text()


def source_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


V, LANES = source_int("V"), source_int("LANES")  # pixels a thread, threads a warp


def test_kernel_constants_match_the_wrapper():
    """The wrapper plans with the kernel's own V, strip and row instances;
    at the Semi loss's shape the grid holds at least 4 warps an SM."""
    assert (V, LANES) == (canny_ops.NMS_PIXELS, canny_ops.NMS_STRIP // canny_ops.NMS_PIXELS)
    assert tuple(int(r) for r in re.findall(r"PRV2_NMS_ROWS\((\d+)\)$", SOURCE, re.M)) == NMS_ROWS
    for planes, h, w in ((4, 384, 512), (1, 1024, 2048), (1, 3, 5)):
        rows = canny_nms_plan(planes, h, w, 132)
        assert rows in NMS_ROWS
        warps = planes * -(-w // (V * LANES)) * -(-h // rows)
        if (planes, h, w) == (4, 384, 512):
            assert warps >= 4 * 132


def walk_model(gi, gj, mag, rows, vector, thresholds=None, region=None):
    """``csrc/canny.cu``'s kernel in numpy, every warp of the grid at once.
    Warp task t of (B, H, W) maps is (column strip, row band, plane), the
    strip fastest; lane l holds the V pixels from x = 128 s + V l of each
    row of its band [R b, R b + R). It loads the magnitude rows y - 1 and y
    and (ahead) y + 1, then walks its rows: the row two ahead and the next
    row's gradients loaded, the new window row built by the shuffles (lane
    l - 1's last pixel, lane l + 1's first; lanes 0 and 31 take their own
    load of the pixel outside the strip), the pixels compared, the window
    rolled. Out-of-map reads give 0; ``vector`` reads and writes whole
    vectors (W a multiple of V), else pixel by pixel. ``thresholds``
    (low, high) selects the mask mode, over ``region`` (a bool mask) or the
    1-pixel interior. Asserts that every pixel is written exactly once."""
    dt = mag.dtype.type
    b, h, w = mag.shape
    strip = V * LANES
    strips, bands = -(-w // strip), -(-h // rows)
    if vector:
        assert w % V == 0
    t = np.arange(b * strips * bands)
    cs, band, pl = t % strips, (t // strips) % bands, t // (strips * bands)
    xs = cs * strip
    x = xs[:, None] + np.arange(LANES) * V  # (T, 32): each lane's first pixel
    cols = x[..., None] + np.arange(V)  # (T, 32, V)
    inside = np.broadcast_to((x < w)[..., None], cols.shape) if vector else cols < w
    pi = pl[:, None, None]

    def load(a, y):  # (T,) rows of a (b, h, w) map -> the lanes' (T, 32, V) values
        ok = ((y >= 0) & (y < h))[:, None, None] & inside
        vals = a[pi, np.clip(y, 0, h - 1)[:, None, None], np.clip(cols, 0, w - 1)]
        return np.where(ok, vals, np.zeros((), a.dtype))

    def load_raw(y):
        xe = np.stack([xs - 1, xs + strip], 1)  # lane 0's and lane 31's extra pixel
        ok = ((y >= 0) & (y < h))[:, None] & (xe >= 0) & (xe < w)
        edge = np.where(ok, mag[pl[:, None], np.clip(y, 0, h - 1)[:, None], np.clip(xe, 0, w - 1)], dt(0))
        return load(mag, y), edge

    def window(raw):  # (T, 32, V + 2): __shfl_up_sync / __shfl_down_sync by one lane
        v, edge = raw
        left = np.concatenate([edge[:, :1], v[:, :-1, V - 1]], 1)
        right = np.concatenate([v[:, 1:, 0], edge[:, 1:]], 1)
        return np.concatenate([left[..., None], v, right[..., None]], 2)

    out = np.zeros((2, b, h, w), bool)
    written = np.zeros((b, h, w), int)
    y0 = band * rows
    up, mid, nxt = window(load_raw(y0 - 1)), window(load_raw(y0)), load_raw(y0 + 1)
    g = (load(gi, y0), load(gj, y0))
    eps, one = dt(1e-12), dt(1)
    for r in range(rows):
        y = y0 + r
        if r + 1 < rows:
            ahead, g2 = load_raw(y + 2), (load(gi, y + 1), load(gj, y + 1))
        dn = window(nxt)
        c, (gi_r, gj_r) = mid[..., 1:V + 1], g
        ai, aj = np.abs(gi_r), np.abs(gj_r)
        same = gi_r * gj_r >= 0
        horiz = aj >= ai
        wgt = np.where(horiz, ai, aj) / (np.where(horiz, aj, ai) + eps)
        lft, ctr, rgt = slice(0, V), slice(1, V + 1), slice(2, V + 2)
        p_diag = np.where(horiz, np.where(same, dn[..., rgt], up[..., rgt]),
                          np.where(same, dn[..., rgt], dn[..., lft]))
        p_axis = np.where(horiz, mid[..., rgt], dn[..., ctr])
        m_diag = np.where(horiz, np.where(same, up[..., lft], dn[..., lft]),
                          np.where(same, up[..., lft], up[..., rgt]))
        m_axis = np.where(horiz, mid[..., lft], up[..., ctr])
        rest = one - wgt
        is_max = (c >= p_diag * wgt + p_axis * rest) & (c >= m_diag * wgt + m_axis * rest)
        if thresholds is None:
            res = (is_max, is_max)
        else:
            yy = y[:, None, None]
            if region is None:
                in_region = (yy >= 1) & (yy + 1 < h) & (cols >= 1) & (cols + 1 < w)
            else:
                in_region = load(region.astype(np.uint8), y) != 0
            keep = is_max & in_region & (c > 0)
            res = tuple(keep & (c >= dt(th)) for th in thresholds)
        store = (y < h)[:, None, None] & inside  # the warp leaves at the map's last row
        idx = (np.broadcast_to(pi, cols.shape)[store], np.broadcast_to(y[:, None, None], cols.shape)[store],
               cols[store])
        for k in range(2):
            out[k][idx] = res[k][store]
        np.add.at(written, idx, 1)
        if r + 1 < rows:
            up, mid, nxt, g = mid, dn, ahead, g2
    assert (written == 1).all(), "a pixel was written other than once"
    return out[0] if thresholds is None else (out[0], out[1])


def check_walk(gi, gj, mag, thresholds, region=None, rows_set=NMS_ROWS):
    """``walk_model`` on every row count and path against the plain versions,
    in the NMS mode and the mask mode (the interior, and ``region`` when
    given). Returns how many pixels the NMS and the two masks kept."""
    t = [torch.from_numpy(a) for a in (gi, gj, mag)]
    lm = canny_nms_plain(*t).numpy()
    low_i, high_i = (m.numpy() for m in canny_nms_masks_plain(*t, *thresholds))
    if region is not None:
        low_r, high_r = (m.numpy() for m in canny_nms_masks_plain(*t, *thresholds, torch.from_numpy(region)))
    for rows in rows_set:
        for vector in ((True, False) if mag.shape[-1] % V == 0 else (False,)):
            np.testing.assert_array_equal(walk_model(gi, gj, mag, rows, vector), lm)
            low, high = walk_model(gi, gj, mag, rows, vector, thresholds)
            np.testing.assert_array_equal(low, low_i)
            np.testing.assert_array_equal(high, high_i)
            if region is not None:
                low, high = walk_model(gi, gj, mag, rows, vector, thresholds, region)
                np.testing.assert_array_equal(low, low_r)
                np.testing.assert_array_equal(high, high_r)
    return int(lm.sum()), int(low_i.sum()), int(high_i.sum())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("w", [1, 3, 127, 128, 129, 257, 512, 513])
def test_walk_model_matches_plain_at_strip_and_band_boundaries(w, dtype):
    """Batch 3, heights 1, R - 1, R and R + 1 for each row count R, seeded
    normal gradients with their magnitude; the region a random mask."""
    rng = np.random.RandomState(w)
    kept = np.zeros(3, int)
    for rows in NMS_ROWS:
        for h in sorted({1, rows - 1, rows, rows + 1}):
            gi, gj = (rng.randn(3, h, w).astype(dtype) for _ in range(2))
            mag = np.hypot(gi, gj).astype(dtype)
            region = rng.rand(3, h, w) < 0.8
            kept += check_walk(gi, gj, mag, (0.5, 1.5), region, (rows,))
    if w >= 3:  # an interior exists at some height
        assert 0 < kept[2] < kept[1] < kept[0]


def tie_maps(kind: str, dtype):
    """(isobel, jsobel, magnitude, thresholds) of shape (3, 19, 260): integer
    gradients (ties between neighbours and sectors; magnitudes 1 and 2 equal
    to the thresholds), or a flat magnitude with pure axis and diagonal
    directions and a patch of zero gradients (the thresholds 1.5, the flat
    value, and 0.7, which float32 rounds down: both sides compare in the
    maps' dtype)."""
    rng = np.random.RandomState(11)
    shape = (3, 19, 260)
    if kind == "integer":
        gi = rng.randint(-2, 3, shape).astype(dtype)
        gj = rng.randint(-2, 3, shape).astype(dtype)
        return gi, gj, np.hypot(gi, gj).astype(dtype), (1.0, 2.0)
    gi = rng.randn(*shape)
    gj = gi.copy()  # diagonal, |i| == |j|
    gj[:, :, 60:120] = -gi[:, :, 60:120]
    gi[:, 5:9] = 0.0  # pure horizontal
    gj[:, 12:15] = 0.0  # pure vertical
    gi[:, :, 200:] = gj[:, :, 200:] = 0.0
    mag = np.full(shape, 1.5)
    mag[:, :, 126:131] = 0.7  # float32 rounds it down, as it does the threshold
    mag[:, 10:17, 240:250] = rng.rand(7, 10)
    return gi.astype(dtype), gj.astype(dtype), mag.astype(dtype), (0.7, 1.5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["integer", "flat"])
def test_walk_model_matches_plain_on_ties(kind, dtype):
    gi, gj, mag, thresholds = tie_maps(kind, dtype)
    region = np.random.RandomState(12).rand(*mag.shape) < 0.9
    lm, low, high = check_walk(gi, gj, mag, thresholds, region)
    assert 0 < high <= low < lm
    masks = canny_nms_masks_plain(*(torch.from_numpy(a) for a in (gi, gj, mag)), *thresholds)
    for th, m in zip(thresholds, masks):  # pixels whose magnitude equals the threshold are kept
        assert (m.numpy() & (mag == mag.dtype.type(th))).any()


def jax_loss_epilogue(gi, gj, mag, low_t, high_t):
    """``canny_edges_graph``'s lines after the JAX ``canny_nms``
    (losses_extra.py:123-128), in jax.numpy."""
    local_maxima = j_canny_nms(jnp, gi, gj, mag)
    interior = jnp.zeros(mag.shape, bool).at[:, 1:-1, 1:-1].set(True)
    local_maxima = local_maxima & interior & (mag > 0)
    return np.asarray(local_maxima & (mag >= low_t)), np.asarray(local_maxima & (mag >= high_t))


def jax_eval_epilogue(gi, gj, mag, mask, low_t, high_t):
    """``_canny_numpy``'s lines after the JAX ``canny_nms``
    (metrics.py:99,105-110), in numpy."""
    eroded_mask = ndi.binary_erosion(mask, np.ones((3, 3), bool), border_value=0)
    local_maxima = j_canny_nms(np, gi, gj, mag)
    local_maxima &= eroded_mask & (mag > 0)
    return local_maxima & (mag >= low_t), local_maxima & (mag >= high_t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind,seed", [("normal", 5), ("integer", 6), ("smooth", 7)])
def test_canny_nms_masks_plain_matches_jax_epilogues(kind, seed, dtype):
    gi, gj, mag = (a.astype(dtype) for a in gradients(kind, seed))
    thresholds = (1.0, 2.0) if kind == "integer" else (0.5, 1.5)
    t = [torch.from_numpy(a) for a in (gi, gj, mag)]
    # the loss: a batch of maps, the interior
    b3 = [np.stack([a, a[::-1], a[:, ::-1]]) for a in (gi, gj, mag)]
    with jax.enable_x64(dtype == np.float64):
        ref = jax_loss_epilogue(*(jnp.asarray(a) for a in b3), *thresholds)
    got = canny_nms_masks(*(torch.from_numpy(a) for a in b3), *thresholds)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bool and 0 < r.sum() < r.size
        np.testing.assert_array_equal(g.numpy(), r)
    # the evaluation: one map, the eroded mask
    mask = np.ones(mag.shape, bool)
    mask[20:40, 30:60] = False
    eroded = ndi.binary_erosion(mask, np.ones((3, 3), bool), border_value=0)
    ref = jax_eval_epilogue(gi, gj, mag, mask, *thresholds)
    got = canny_nms_masks_plain(*t, *thresholds, torch.from_numpy(eroded))
    for g, r in zip(got, ref):
        assert 0 < r.sum() < r.size
        np.testing.assert_array_equal(g.numpy(), r)


def test_canny_nms_masks_checks_its_inputs():
    gi, gj, mag = (torch.from_numpy(a) for a in gradients("normal", 8, (2, 9, 11)))
    with pytest.raises(ValueError, match="mask of the maps' shape"):
        canny_nms_masks(gi, gj, mag, 0.1, 0.2, torch.ones((9, 11), dtype=torch.bool))
    with pytest.raises(TypeError, match="bool mask"):
        canny_nms_masks(gi, gj, mag, 0.1, 0.2, torch.ones(mag.shape))
    with pytest.raises(ValueError, match="one shape"):
        canny_nms_masks(gi, gj[:, :, :3], mag, 0.1, 0.2)
    m = torch.empty((2, 9, 11), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        canny_nms_masks(m, m, m, 0.1, 0.2)


def depth_map(seed: int, shape=(64, 96)) -> np.ndarray:
    """Piecewise-smooth metric depth in (1, 250): blocks of constant depth
    with ramps and a little noise, so that edges of every strength occur."""
    rng = np.random.RandomState(seed)
    h, w = shape
    blocks = rng.uniform(1.5, 200.0, (4, 6))
    yy, xx = np.mgrid[0:h, 0:w]
    d = blocks[yy * 4 // h, xx * 6 // w]
    d = d * (1 + 0.3 * np.sin(yy / 7.0 + seed) * np.cos(xx / 11.0))
    d = d * np.exp(0.05 * ndi.gaussian_filter(rng.randn(h, w), 1.5))
    return np.clip(d, 1.0, 249.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("preprocess", ["log", "inv"])
def test_extract_edges_matches_jax(seed, preprocess):
    d = depth_map(seed)
    if seed == 2:
        d[:5, :7] = 0.0  # no depth: log 0, inverse 0
    ref = jmetrics.extract_edges(d, preprocess=preprocess)
    got = metrics.extract_edges(torch.from_numpy(d), preprocess=preprocess).numpy()
    assert 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(got, ref)
    d32 = d.astype(np.float32)  # the dtype of a resized prediction
    np.testing.assert_array_equal(metrics.extract_edges(torch.from_numpy(d32), preprocess=preprocess).numpy(),
                                  jmetrics.extract_edges(d32, preprocess=preprocess))


@pytest.mark.parametrize("seed", [3, 4])
def test_canny_hysteresis_mask_and_thresholds_match_jax(seed):
    x = np.log(depth_map(seed))
    mask = np.ones(x.shape, bool)
    mask[20:40, 30:60] = False
    for kw in (dict(), dict(mask=mask), dict(low_threshold=0.05, high_threshold=0.3, sigma=1.5)):
        ref = jmetrics._canny_numpy(x, **kw)
        got = metrics.canny(torch.from_numpy(x), **kw).numpy()
        np.testing.assert_array_equal(got, ref)
    # the hysteresis decides: it keeps more than the high mask and less than the low one
    low = jmetrics._canny_numpy(x, low_threshold=0.05, high_threshold=0.05)
    high = jmetrics._canny_numpy(x, low_threshold=0.3, high_threshold=0.3)
    both = metrics.canny(torch.from_numpy(x), low_threshold=0.05, high_threshold=0.3).numpy()
    assert high.sum() < both.sum() < low.sum()
