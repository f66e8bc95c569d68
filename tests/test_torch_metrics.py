"""The port's depth and boundary metrics and the Cityscapes ``get_metrics``
surface against the JAX package on the CPU.

Inputs are numpy arrays from a seed handed to both sides. Bars:

- depth metrics (``compute_errors``, ``compute_metrics`` with its resize,
  clamping, crops and SEE): rel 1e-6. The port resizes the prediction with
  K2 in float32 where the JAX package resizes in float64 (~1e-7 relative);
  the a1..a3 fractions are equal.
- ``get_boundaries(dilation=0)``: equal.
- boundary metrics: equal counts (precision, recall, F1) and EdgeAcc /
  EdgeComp within rel 1e-12 (means over the same pixels, summed in another
  order) when the prediction has the gt shape; within rel 1e-3 when it must
  first be resized (K2 in float32 against the JAX ``resize_hwc``): a
  one-ulp change of a prediction can flip a near-tie pixel of the
  non-maximum suppression. The count of edge pixels that differ is printed
  (``pytest -s``).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from patchrefinerv2_tpu.datasets.cityscapes import CityScapesDataset as JCityScapes
from patchrefinerv2_tpu.datasets.transforms import resize_hwc as j_resize_hwc
from patchrefinerv2_tpu.evaluation import metrics as jm

from patchrefinerv2_torch.datasets.cityscapes import CityScapesDataset
from patchrefinerv2_torch.evaluation import metrics as pm
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_canny import depth_map

T = torch.from_numpy


def assert_metrics(got: dict, ref: dict, rel: float, exact=("a1", "a2", "a3")):
    assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        v = float(v)
        if k in exact:
            assert got[k] == v, (k, got[k], v)
        assert abs(got[k] - v) <= rel * abs(v), (k, got[k], v)


def test_compute_errors_matches_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(0.5, 80.0, 5000)
    pred = gt * np.exp(rng.randn(5000) * 0.3)
    assert_metrics(pm.compute_errors(T(gt), T(pred)), jm.compute_errors(gt, pred), 1e-12)


CASES = {
    "same shape, no crop": dict(shape=(60, 80), kw=dict(garg_crop=False, eigen_crop=False)),
    "resized, no crop": dict(shape=(48, 64), kw=dict(garg_crop=False, eigen_crop=False)),
    "resized, garg crop": dict(shape=(48, 64), kw=dict(garg_crop=True)),
    "resized, eigen crop kitti": dict(shape=(48, 64), kw=dict(eigen_crop=True, dataset="kitti")),
    "eigen crop nyu, SEE, extra mask": dict(gt=(480, 640), shape=(240, 320), edges=True,
                                            extra=True, kw=dict(eigen_crop=True)),
    "SEE resized": dict(shape=(30, 40), edges=True, kw=dict(garg_crop=False, eigen_crop=False)),
    # on a map of the gt shape: the JAX package's dense resize spreads a nan
    # over the whole map, K2 over its taps only
    "SEE, clamped inf and nan": dict(shape=(60, 80), edges=True, bad=True,
                                                kw=dict(garg_crop=False, eigen_crop=False,
                                                        min_depth_eval=1e-3, max_depth_eval=80)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_compute_metrics_matches_jax(name):
    c = CASES[name]
    rng = np.random.RandomState(len(name))
    gh, gw = c.get("gt", (60, 80))
    gt = depth_map(1, (gh, gw)) / 3.0
    gt[:4] = 0.0  # invalid gt rows
    pred = np.clip(ndi.zoom(gt, (c["shape"][0] / gh, c["shape"][1] / gw), order=1), 0.5, None)
    pred = (pred * np.exp(rng.randn(*pred.shape) * 0.2)).astype(np.float32)
    if c.get("bad"):
        pred[3, 5], pred[10, 12], pred[20, 30] = np.inf, np.nan, -np.inf
    kw = dict(c["kw"])
    if c.get("edges"):
        kw["disp_gt_edges"] = jm.get_boundaries(gt, th=1.0, dilation=0)
    if c.get("extra"):
        kw["additional_mask"] = rng.rand(gh, gw) > 0.3
    ref = jm.compute_metrics(gt[None, :, :, None], pred[None, :, :, None], **kw)
    kw = {k: (T(np.asarray(v)) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = pm.compute_metrics(T(gt[None, :, :, None]), T(pred[None, :, :, None]), **kw)
    assert ("see" in got) == bool(c.get("edges")) and len(got) >= 9
    assert_metrics(got, ref, 1e-6)


def test_compute_metrics_without_valid_pixels_is_empty():
    gt = np.zeros((20, 30))
    assert pm.compute_metrics(T(gt), T(gt + 1.0), eigen_crop=False) == {} == \
        jm.compute_metrics(gt, gt + 1.0, eigen_crop=False)


def test_get_boundaries_matches_jax():
    disp = depth_map(2, (48, 72)).astype(np.float32)
    disp[10:20, 30:33] += 0.9  # steps just under and over the threshold
    disp[30:, 40:] += 1.1
    ref = jm.get_boundaries(disp, th=1.0, dilation=0)
    got = pm.get_boundaries(T(disp), th=1.0, dilation=0)
    assert got.dtype == torch.float32 and 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(NotImplementedError):
        pm.get_boundaries(T(disp), dilation=10)


def edges_pair(seed):
    rng = np.random.RandomState(seed)
    gt_edges = jm.extract_edges(depth_map(seed), preprocess="log")
    pred_edges = np.roll(gt_edges, (1, 2), (0, 1)) & (rng.rand(*gt_edges.shape) > 0.2)
    valid = rng.rand(*gt_edges.shape) > 0.1
    return gt_edges, pred_edges, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_boundary_metrics_matches_jax(seed):
    gt_edges, pred_edges, valid = edges_pair(seed)
    gt = depth_map(seed)
    ref = jm.compute_boundary_metrics(gt, gt, gt_edges, valid, pred_edges)
    got = pm.compute_boundary_metrics(T(gt), T(gt), T(gt_edges), T(valid), T(pred_edges))
    assert_metrics(got, ref, 1e-12, exact=("precision", "recall", "f1"))
    # no prediction edge close to a gt edge: the threshold values
    far = np.zeros_like(gt_edges)
    far[0, 0] = True
    solo = np.zeros_like(gt_edges)
    solo[-1, -1] = True
    assert_metrics(pm.compute_boundary_metrics(T(gt), T(gt), T(solo), T(valid), T(far)),
                   jm.compute_boundary_metrics(gt, gt, solo, valid, far), 0.0,
                   exact=("EdgeAcc", "EdgeComp", "precision", "recall", "f1"))


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    split = tmp_path_factory.mktemp("cs") / "empty.txt"
    split.write_text("")
    kw = dict(mode="infer", split=str(split), transform_cfg={}, min_depth=1e-3, max_depth=250)
    return JCityScapes(**kw), CityScapesDataset(**kw)


def cs_frame(seed, shape=(64, 96)):
    """gt depth with invalid and sky pixels, its boundary, a color seg map
    whose labels follow the depth blocks, and a prediction near the gt."""
    rng = np.random.RandomState(seed)
    gt = depth_map(seed, shape).astype(np.float32)
    gt[-shape[0] // 4:] = -1.0
    gt[:3, :10] = 0.0
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    lab = rng.randint(0, 5, (4, 6))[yy * 4 // shape[0], xx * 6 // shape[1]]
    palette = rng.randint(0, 256, (5, 3))
    seg = palette[lab].astype(np.uint8)
    pred = np.clip(gt, 2.0, None) * np.exp(0.15 * ndi.gaussian_filter(rng.randn(*shape), 2))
    return gt, jm.get_boundaries(gt, th=1, dilation=0), seg, lab, pred.astype(np.float32)


@pytest.mark.parametrize("color", [True, False])
def test_cityscapes_get_metrics_same_shape_matches_jax(cityscapes, color):
    jds, ds = cityscapes
    gt, boundary, seg, lab, pred = cs_frame(5)
    s = seg if color else lab
    ref = jds.get_metrics(gt[None, :, :, None], pred, disp_gt_edges=boundary[None], seg_image=s[None])
    got = ds.get_metrics(gt[None, :, :, None], T(pred), disp_gt_edges=boundary[None],
                         seg_image=s[None])
    assert {"see", "EdgeAcc", "EdgeComp", "precision", "recall", "f1"} <= set(got)
    assert_metrics(got, ref, 1e-6, exact=("a1", "a2", "a3", "precision", "recall", "f1"))
    # without a seg map: the depth metrics alone, no crop
    assert_metrics(ds.get_metrics(gt, T(pred)), jds.get_metrics(gt, pred), 1e-6)


@pytest.mark.parametrize("seed", [6, 7])
def test_cityscapes_get_metrics_resized_matches_jax(cityscapes, seed):
    jds, ds = cityscapes
    gt, boundary, seg, _, pred = cs_frame(seed, (192, 288))
    small = ndi.zoom(pred, (2 / 3, 2 / 3), order=1).astype(np.float32)
    ref = jds.get_metrics(gt[None, :, :, None], small, disp_gt_edges=boundary, seg_image=seg)
    got = ds.get_metrics(gt[None, :, :, None], T(small), disp_gt_edges=boundary, seg_image=seg)
    e_ref = jm.extract_edges(j_resize_hwc(small[..., None], gt.shape)[..., 0], preprocess="log")
    e_got = pm.extract_edges(pm.resize(T(small)[None, :, :, None], gt.shape, "bilinear", True)[0, :, :, 0],
                             preprocess="log").numpy()
    print(f"seed {seed}: {int((e_ref != e_got).sum())} of {int(e_ref.sum())} edge pixels differ")
    assert_metrics(got, ref, 1e-3, exact=("a1", "a2", "a3"))
