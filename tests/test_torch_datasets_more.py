"""The port's KITTI, ScanNet++, ETH3D and folder-of-images readers against
the JAX package's, on files each test writes: before each sample both
sides get ``random`` and ``np.random`` seeded alike, and every key must be
equal bit for bit. The exception is the folder reader's bicubic resize of
an image to ``image_resolution``, held within 1e-6 absolute on values in
[0, 1] (``resize_hwc``'s bicubic mode, as tests/test_torch_datasets.py
holds it). Also ``read_pfm`` in both layouts and endians, ScanNet's edge /
flat metrics and the readers' registration in ``build_dataset``."""

import os

import numpy as np
import pytest

from patchrefinerv2_tpu.datasets import general as jgeneral
from patchrefinerv2_tpu.datasets.eth3d import ETHDataset as JETH
from patchrefinerv2_tpu.datasets.kitti import KittiDataset as JKitti
from patchrefinerv2_tpu.datasets.scannet import ScanNetDataset as JScanNet
from patchrefinerv2_tpu.datasets.utils import read_pfm as jread_pfm

from patchrefinerv2_torch.datasets import general
from patchrefinerv2_torch.datasets.eth3d import ETHDataset
from patchrefinerv2_torch.datasets.kitti import KittiDataset
from patchrefinerv2_torch.datasets.scannet import ScanNetDataset
from patchrefinerv2_torch.datasets.utils import read_pfm
from patchrefinerv2_torch.train import build_dataset
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_datasets import assert_same_sample, jax_native, seeded, write_png


@pytest.fixture(scope="module", autouse=True)
def jax_host_library():
    jax_native()


def same_for_seeds(port, ref, idx, seeds):
    for seed in seeds:
        a = seeded(lambda: port[idx], seed)
        assert_same_sample(a, seeded(lambda: ref[idx], seed))
    return a


# ---------------------------------------------------------------------- KITTI
KITTI_RAW = (375, 1242)  # a raw KITTI frame; the readers KB-crop it to 352x1216


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """Two frames at 375x1242 in the KITTI layout: the image PNG, a sparse
    uint16 depth PNG (~5% of the pixels valid, 256 x depth) and the offline
    pseudo label the reader names from the image path (at 352x1216, the
    crop's size); a split with a third line whose depth is ``None``."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.RandomState(11)
    lines = []
    for i in range(2):
        img = f"2011_09_26/2011_09_26_drive_0001_sync/image_02/data/{i:010d}.png"
        dep = f"2011_09_26_drive_0001_sync/proj_depth/groundtruth/image_02/{i:010d}.png"
        write_png(str(root / img), rng.randint(0, 256, (*KITTI_RAW, 3), np.uint8))
        depth = np.zeros(KITTI_RAW, np.uint16)
        valid = rng.rand(*KITTI_RAW) < 0.05
        depth[valid] = (rng.uniform(1.0, 80.0, valid.sum()) * 256).astype(np.uint16)
        write_png(str(root / dep), depth)
        pl = root / "pl" / img.replace("/", "_").replace(".png", "_uint16.png")
        write_png(str(pl), (rng.uniform(1.0, 80.0, (352, 1216)) * 256).astype(np.uint16))
        lines.append(f"{img} {dep} 721.5377")
    lines.append("2011_09_26/none/image_02/data/0000000009.png None 721.5377")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return dict(data_root=str(root), split=str(root / "split.txt"), pl=str(root / "pl"))


def kitti_kwargs(kitti, mode, **extra):
    return dict(mode=mode, split=kitti["split"], data_root=kitti["data_root"], min_depth=1e-3,
                max_depth=80, patch_raw_shape=[176, 304],
                transform_cfg=dict(degree=1.0, network_process_size=[384, 512],
                                   image_raw_shape=[352, 1216]), **extra)


@pytest.mark.parametrize("case", ["train", "train_pseudo", "infer"])
def test_kitti_sample_equals_jax(kitti, case):
    extra = dict(with_pseudo_label=True, pseudo_label_path=kitti["pl"]) if case == "train_pseudo" else {}
    kw = kitti_kwargs(kitti, case.split("_")[0], **extra)
    port, ref = KittiDataset(**kw), JKitti(**kw)
    assert len(port) == len(ref) == 2  # the ``None`` line skipped
    a = same_for_seeds(port, ref, 1, (1, 2) if case != "infer" else (1,))
    if case == "infer":
        assert a["image_hr"].shape == (352, 1216, 3) and a["boundary"].any()
        assert a["image_lr"].shape == (384, 512, 3)
    else:
        assert a["crops_image_hr"].shape == (384, 512, 3) and a["crop_depths"].shape == (176, 304, 1)
        assert ("pseudo_label" in a) == (case == "train_pseudo")


def test_kitti_split_lines_equal_jax(kitti):
    """The split's infos (the ``None`` line skipped, the pseudo-label names)
    and the metric settings (Garg crop) equal the JAX reader's."""
    kw = kitti_kwargs(kitti, "train", with_pseudo_label=True, pseudo_label_path=kitti["pl"])
    port, ref = KittiDataset(**kw), JKitti(**kw)
    assert port.data_infos == ref.data_infos
    assert all(os.path.exists(i["pseudo_label_path"]) for i in port.data_infos)
    assert (port.garg_crop, port.eigen_crop, port.dataset_name) == (True, False, "kitti")


def test_kitti_metrics_take_the_garg_crop(kitti):
    kw = kitti_kwargs(kitti, "infer")
    port, ref = KittiDataset(**kw), JKitti(**kw)
    s = port[0]
    pred = np.clip(s["depth_gt"][..., 0], 1.0, None) * 1.05 + 0.5
    got, want = port.get_metrics(s["depth_gt"], pred), ref.get_metrics(s["depth_gt"], pred)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * max(abs(v), 1e-12), (k, got[k], v)


# ------------------------------------------------------------------- ScanNet++
SN_RAW = (48, 64)  # a reduced image_raw_shape


@pytest.fixture(scope="module")
def scannet(tmp_path_factory):
    """Three frames: one at ``SN_RAW``, one whose image is 36x50 (resized
    bilinearly to ``SN_RAW``), one whose depth is 24x32 (resized nearest);
    uint16 depth PNGs (1000 x depth, steps so that the boundary has edges),
    and the pseudo labels the reader names from the image paths."""
    root = tmp_path_factory.mktemp("scannet")
    rng = np.random.RandomState(12)
    lines = []
    for i, (ishape, dshape) in enumerate(((SN_RAW, SN_RAW), ((36, 50), SN_RAW), (SN_RAW, (24, 32)))):
        img, dep = f"scene{i}/dslr/rgb/DSC{i:05d}.JPG.png", f"scene{i}/dslr/depth/DSC{i:05d}.png"
        write_png(str(root / img), rng.randint(0, 256, (*ishape, 3), np.uint8))
        d = rng.uniform(0.5, 8.0, dshape)
        d[:, dshape[1] // 2:] += 2.0
        write_png(str(root / dep), (d * 1000).astype(np.uint16))
        pl = root / "pl" / (img.replace("/", "_").rsplit(".", 1)[0] + "_uint16.png")
        write_png(str(pl), (rng.uniform(0.5, 9.0, SN_RAW) * 256).astype(np.uint16))
        lines.append(f"{img} {dep}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return dict(data_root=str(root), split=str(root / "split.txt"), pl=str(root / "pl"))


def scannet_kwargs(sn, mode, **extra):
    return dict(mode=mode, split=sn["split"], data_root=sn["data_root"], min_depth=1e-3, max_depth=10,
                patch_raw_shape=[24, 32],
                transform_cfg=dict(degree=1.0, network_process_size=[24, 32],
                                   image_raw_shape=list(SN_RAW)), **extra)


@pytest.mark.parametrize("case", ["train", "train_pseudo", "infer"])
def test_scannet_sample_equals_jax(scannet, case):
    extra = dict(with_pseudo_label=True, pseudo_label_path=scannet["pl"]) if case == "train_pseudo" else {}
    kw = scannet_kwargs(scannet, case.split("_")[0], **extra)
    port, ref = ScanNetDataset(**kw), JScanNet(**kw)
    assert len(port) == len(ref) == 3 and port.data_infos == ref.data_infos
    for idx in range(3):  # as is, the image resized, the depth resized nearest
        a = same_for_seeds(port, ref, idx, (3, 4) if case != "infer" else (3,))
        assert a["depth_gt"].shape == (*SN_RAW, 1)
        assert ("pseudo_label" in a) == (case == "train_pseudo")


def test_scannet_nearest_depth_resize_equals_jax(scannet):
    """The reader's nearest resize of a depth (``resize_hwc``) equals the
    JAX reader's one-hot product of ``resize_matrix(..., "nearest")`` rows
    at sizes either way."""
    from patchrefinerv2_tpu.ops.resize import resize_matrix

    from patchrefinerv2_torch.datasets.transforms import resize_hwc

    rng = np.random.RandomState(13)
    for src, dst in (((24, 32), (48, 64)), ((37, 53), (48, 64)), ((90, 70), (48, 64)), ((5, 7), (3, 11))):
        d = rng.uniform(0, 10, src).astype(np.float32)
        wh, ww = (resize_matrix(s, t, "nearest", False) for s, t in zip(src, dst))
        want = (wh @ d.astype(np.float64) @ ww.T).astype(np.float32)
        np.testing.assert_array_equal(resize_hwc(d, dst, "nearest", False), want)


def test_scannet_get_metrics_equals_jax(scannet):
    """The edge / flat split: the same keys, each within 1e-6 relative."""
    kw = scannet_kwargs(scannet, "infer")
    port, ref = ScanNetDataset(**kw), JScanNet(**kw)
    s = port[0]
    pred = np.clip(s["depth_gt"][..., 0], 0.1, None) * 1.1 + np.linspace(0, 0.3, SN_RAW[1])[None, :]
    args = (s["depth_gt"][None], pred)
    got = port.get_metrics(*args, disp_gt_edges=s["boundary"][None])
    want = ref.get_metrics(*args, disp_gt_edges=s["boundary"][None])
    assert sorted(got) == sorted(want) and any(k.startswith("edge_") for k in got)
    assert any(k.startswith("flat_") for k in got) and "see" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * max(abs(v), 1e-12), (k, got[k], v)
    assert port.get_metrics(*args) == pytest.approx(ref.get_metrics(*args), rel=1e-6)


# ----------------------------------------------------------------------- ETH3D
@pytest.fixture(scope="module")
def eth(tmp_path_factory):
    """Three frames: a 40x60 image with its float32 ``.raw`` depth (NaN and
    infinities in it), a 30x45 image (resized to the 40x60 raw shape) with
    its ``.bin`` depth at 30x45, and a 40x60 image with a PNG depth."""
    root = tmp_path_factory.mktemp("eth3d")
    rng = np.random.RandomState(14)
    lines = []
    for i, (shape, ext) in enumerate((((40, 60), ".raw"), ((30, 45), ".bin"), ((40, 60), ".png"))):
        img, dep = f"court/images/dslr_images/DSC_{i:04d}.JPG.png", f"court/depth/DSC_{i:04d}{ext}"
        write_png(str(root / img), rng.randint(0, 256, (*shape, 3), np.uint8))
        d = rng.uniform(0.5, 30.0, shape).astype(np.float32)
        d[:, shape[1] // 3:] += 5.0
        if ext == ".png":
            write_png(str(root / dep), (d * 1000).astype(np.uint16))
        else:
            d[0, :3] = (np.nan, np.inf, -np.inf)
            os.makedirs(os.path.dirname(root / dep), exist_ok=True)
            d.tofile(root / dep)
        lines.append(f"{img} {dep}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return dict(data_root=str(root), split=str(root / "split.txt"))


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_eth3d_sample_equals_jax(eth, mode):
    """A ``.raw`` or ``.bin`` depth gives the infer-mode sample in train mode
    too (the JAX reader's quirk, kept: no ``crops_image_hr``); a PNG depth
    takes the ScanNet++ path."""
    kw = dict(mode=mode, split=eth["split"], data_root=eth["data_root"], min_depth=1e-3, max_depth=80,
              patch_raw_shape=[20, 30], transform_cfg=dict(degree=1.0, network_process_size=[24, 32],
                                                          image_raw_shape=[40, 60]))
    port, ref = ETHDataset(**kw), JETH(**kw)
    seeds = (5, 6) if mode == "train" else (5,)
    raw = same_for_seeds(port, ref, 0, seeds)
    assert "crops_image_hr" not in raw and raw["image_hr"].shape == (40, 60, 3)
    assert np.isfinite(raw["depth_gt"]).all() and raw["depth_gt"][0, 0, 0] == 0.0
    resized = same_for_seeds(port, ref, 1, seeds)
    assert resized["image_hr"].shape == (40, 60, 3) and resized["depth_gt"].shape == (30, 45, 1)
    png = same_for_seeds(port, ref, 2, seeds)
    assert ("crops_image_hr" in png) == (mode == "train")


def test_eth3d_defaults_equal_jax(eth):
    kw = dict(mode="infer", split=eth["split"], transform_cfg={})
    port, ref = ETHDataset(**kw), JETH(**kw)
    assert port.patch_raw_shape == ref.patch_raw_shape == (2016, 3024)
    assert port.image_raw_shape == ref.image_raw_shape == (4032, 6048)
    assert port.dataset_name == ref.dataset_name == "eth3d"


# ------------------------------------------------------------ folder of images
def write_mid_gt(gt_dir, name, rng, shape, endian):
    """A Middlebury PFM disparity (infinite where invalid) and its calibration
    file under ``calibs``."""
    disp = rng.uniform(20.0, 200.0, shape).astype(np.float32)
    disp[:, shape[1] // 2:] -= 15.0
    disp[2, 3] = np.inf
    write_pfm(os.path.join(gt_dir, f"{name}.pfm"), disp, endian)
    calib_dir = gt_dir.replace("gts", "calibs")
    os.makedirs(calib_dir, exist_ok=True)
    with open(os.path.join(calib_dir, f"{name}.txt"), "w") as f:
        f.write("cam0=[3997.684 0 1176.728; 0 3997.684 1011.728; 0 0 1]\n"
                "cam1=[3997.684 0 1307.839; 0 3997.684 1011.728; 0 0 1]\n"
                "doffs=131.111\nbaseline=193.001\nwidth=2964\nheight=1988\n")


def write_pfm(path, data, endian="<"):
    """A PFM file: ``PF`` for (H, W, 3), ``Pf`` for (H, W); the scale's sign
    gives the endian; rows stored bottom first."""
    with open(path, "wb") as f:
        f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n" if endian == "<" else b"1.0\n")
        f.write(np.flipud(data).astype(endian + "f4").tobytes())


def folder_case(root, name, rng):
    """(rgb_image_dir, gt_dir or None, image_resolution, files to remove)
    for the folder reader's branch ``name``."""
    import cv2

    rgb, gt = os.path.join(root, name, "rgb"), os.path.join(root, name, "val_gt" if name == "u4k" else "gts")
    os.makedirs(rgb)
    os.makedirs(gt)
    small = (30, 40)
    if name == "u4k":  # the full 2160x3840 blob, a disparity npy and its factor file
        rng.randint(0, 256, (2160, 3840, 3), np.uint8).tofile(os.path.join(rgb, "a.raw"))
        disp = rng.uniform(1.0, 64.0, (2160, 3840)).astype(np.float32)
        disp[:, :100] = 0.0  # invalid: depth 0
        np.save(os.path.join(gt, "a.npy"), disp)
        os.makedirs(gt.replace("val_gt", "val_factor"))
        with open(os.path.join(gt.replace("val_gt", "val_factor"), "a.txt"), "w") as f:
            f.write("190.5\n")
        return rgb, gt, None
    if name == "eth3d":  # the generic image path, and the full 4032x6048 float32 depth
        cv2.imwrite(os.path.join(rgb, "a.png"), rng.randint(0, 256, (*small, 3), np.uint8))
        d = rng.uniform(0.5, 30.0, (4032, 6048)).astype(np.float32)
        d[0, :2] = (np.nan, np.inf)
        d.tofile(os.path.join(gt, "a.raw"))
        return rgb, gt, (60, 80)
    if name == "kitti":
        cv2.imwrite(os.path.join(rgb, "a.png"), rng.randint(0, 256, (*KITTI_RAW, 3), np.uint8))
        return rgb, None, None
    if name == "mid":
        cv2.imwrite(os.path.join(rgb, "a.png"), rng.randint(0, 256, (*small, 3), np.uint8))
        write_mid_gt(gt, "a", rng, small, "<")
        return rgb, gt, (45, 70)
    if name == "gta":
        cv2.imwrite(os.path.join(rgb, "a.jpg"), rng.randint(0, 256, (*small, 3), np.uint8))
        d = rng.uniform(1.0, 200.0, small)
        d[:, 20:] += 10.0
        cv2.imwrite(os.path.join(gt, "a.png"), (d * 256).astype(np.uint16))
        return rgb, gt, small  # the image at image_resolution: no resize
    if name == "cityscapes":
        cv2.imwrite(os.path.join(rgb, "a.png"), rng.randint(0, 256, (*small, 3), np.uint8))
        disp = (rng.uniform(2.0, 60.0, small) * 256 + 1).astype(np.uint16)
        disp[:3, :3] = 0
        cv2.imwrite(os.path.join(gt, "a.png"), disp)
        return rgb, gt, None
    # the generic branch without ground truth, with files the filters leave out
    for ext in (".bmp", ".jpeg"):
        cv2.imwrite(os.path.join(rgb, f"b{ext}"), rng.randint(0, 256, (*small, 3), np.uint8))
    open(os.path.join(rgb, "notes.txt"), "w").close()
    return rgb, None, (41, 57)


FOLDER_CASES = ["u4k", "eth3d", "kitti", "mid", "gta", "cityscapes", "generic"]


@pytest.mark.parametrize("name", FOLDER_CASES)
def test_image_dataset_sample_equals_jax(tmp_path, name):
    """``ImageDataset`` over each ``read_general_image`` and
    ``read_general_depth`` branch, against the JAX reader: bit for bit but
    the bicubic resize to ``image_resolution`` (within 1e-6). The u4k and
    eth3d files are at their full hard-coded sizes and removed after."""
    rng = np.random.RandomState(FOLDER_CASES.index(name))
    rgb, gt, res = folder_case(str(tmp_path), name, rng)
    kw = dict(rgb_image_dir=rgb, dataset_name="" if name == "generic" else name, gt_dir=gt,
              network_process_size=(24, 32), image_resolution=res)
    try:
        port, ref = general.ImageDataset(**kw), jgeneral.ImageDataset(**kw)
        assert port.files == ref.files and len(port) >= 1
        for idx in range(len(port)):
            a, b = port[idx], ref[idx]
            bicubic = name in ("eth3d", "mid", "generic")
            assert sorted(a) == sorted(b)
            for k in b:
                if bicubic and k in ("image_hr", "image_lr"):
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
                else:
                    assert_same_sample({k: a[k]}, {k: b[k]})
        if gt is not None:
            assert a["boundary"].any() and np.isfinite(a["depth_gt"]).all()
        if name == "kitti":
            assert a["image_hr"].shape == (352, 1216, 3)
        if res is not None:
            assert a["image_hr"].shape == (*res, 3) and a["image_hr"].min() >= 0.0
    finally:
        for d in (rgb, gt):
            if d is not None:
                for f in os.listdir(d):
                    os.remove(os.path.join(d, f))
    if name == "generic":
        assert port.files == ["b.bmp", "b.jpeg"]


def test_general_depth_reader_raises_for_an_unknown_dataset(tmp_path):
    for reader in (general.read_general_depth, jgeneral.read_general_depth):
        with pytest.raises(NotImplementedError, match="no GT reader"):
            reader(str(tmp_path / "a.png"), "nyu")


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("endian", ["<", ">"])
def test_read_pfm_equals_jax(tmp_path, color, endian):
    rng = np.random.RandomState(15)
    data = rng.randn(*((5, 7, 3) if color else (5, 7))).astype(np.float32)
    path = str(tmp_path / "x.pfm")
    write_pfm(path, data, endian)
    (got, gscale), (want, wscale) = read_pfm(path), jread_pfm(path)
    assert gscale == wscale == 1.0 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n1.0\n")
    with pytest.raises(ValueError, match="not a PFM"):
        read_pfm(str(tmp_path / "bad.pfm"))


def test_build_dataset_builds_the_new_readers(kitti, scannet, eth, tmp_path):
    for cfg, cls in ((dict(type="KittiDataset", **kitti_kwargs(kitti, "infer")), KittiDataset),
                     (dict(type="ScanNetDataset", **scannet_kwargs(scannet, "infer")), ScanNetDataset),
                     (dict(type="ETHDataset", mode="infer", split=eth["split"], transform_cfg={}),
                      ETHDataset),
                     (dict(type="ImageDataset", rgb_image_dir=str(tmp_path)), general.ImageDataset)):
        assert type(build_dataset(cfg)) is cls
