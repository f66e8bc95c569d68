"""K11 (canny non-maximum suppression) and the port's canny edges against the
JAX package on the CPU, where ``canny_nms`` takes its plain version.

- ``canny_nms_plain`` against the JAX ``canny_nms`` over numpy and over
  ``jax.numpy`` (64-bit) on seeded gradients with exact ties (small integer
  gradients, constant magnitudes, pure axis and diagonal directions) and
  zero gradients: the masks are equal in float64 (and in float32 against
  numpy), since the plain version does the reference's operations in its
  order.
- ``extract_edges`` (log and inverse preprocessing) and ``canny`` (with and
  without a mask, other thresholds) against ``extract_edges`` /
  ``_canny_numpy`` on seeded 64x96 depth maps: the masks are equal. The
  smoothing and the Sobel gradients follow scipy's order of operations, and
  the hysteresis is exact (the 8-connected components of the low mask that
  hold a high pixel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import ndimage as ndi

from patchrefinerv2_tpu.evaluation import metrics as jmetrics
from patchrefinerv2_tpu.ops.canny import canny_nms as j_canny_nms

from patchrefinerv2_torch.evaluation import metrics
from patchrefinerv2_torch.ops.canny import canny_nms, canny_nms_plain
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
