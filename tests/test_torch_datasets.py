"""The port's data path against the JAX package's, on files the fixtures
write: the UnrealStereo4K reader (train with the rotation, infer,
``consistency=True``) on one 2160x3840 frame, the Cityscapes reader (train
with the sky file, the border marks, pseudo labels and their uncertainty;
infer with the gtFine colour map) on small PNGs, the transforms and the
loader's batches. Before each sample both sides get
``random`` and ``np.random`` seeded alike; every key must be equal bit for
bit (the host library is the same source built with the same flags as the
JAX package's ``native/``). Only ``resize_hwc``'s bicubic mode, which no
reader uses, is held within 1e-6 absolute on values in [0, 1]: it sums
four taps in float64 in another order than JAX's ``einsum`` over its
matrix, and the float32 results differ by an ulp at some pixels."""

import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from patchrefinerv2_tpu.datasets import native as jnative
from patchrefinerv2_tpu.datasets import transforms as jt
from patchrefinerv2_tpu.datasets.base import DataLoader as JLoader
from patchrefinerv2_tpu.datasets.cityscapes import CityScapesDataset as JCityScapes
from patchrefinerv2_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from patchrefinerv2_tpu.datasets.u4k import UnrealStereo4kDataset as JU4K

from patchrefinerv2_torch.datasets import native, transforms as pt
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.cityscapes import CityScapesDataset
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.datasets.u4k import UnrealStereo4kDataset
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent


def jax_native():
    """The JAX package's host library, loaded (another test process may be
    building it at the moment: its loader then reports it missing, and the
    JAX reader would fall back to numpy, which rounds otherwise)."""
    for _ in range(5):
        if jnative.available():
            return
        jnative._LIB = None
        time.sleep(2)
    raise AssertionError("the JAX package's native library did not load")


def seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def assert_same_sample(a: dict, b: dict):
    assert list(a) == list(b) or sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (k, a[k].dtype, b[k].dtype)
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def write_png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)  # uint16 as a 16-bit PNG


# ------------------------------------------------------------- UnrealStereo4K
@pytest.fixture(scope="module")
def u4k(tmp_path_factory):
    """One 2160x3840 frame: a random BGR blob, a disparity in (1, 64) with
    steps (so that the boundary has edges) and the two extrinsics files."""
    root = tmp_path_factory.mktemp("u4k")
    rng = np.random.RandomState(0)
    scene = root / "00000"
    for d in ("Image0", "Disp0", "Extrinsics0", "Extrinsics1"):
        (scene / d).mkdir(parents=True)
    rng.randint(0, 256, (2160, 3840, 3), np.uint8).tofile(scene / "Image0" / "000.raw")
    disp = rng.uniform(1.0, 64.0, (2160, 3840)).astype(np.float32)
    disp[:, 1000:] = np.float32(30.0)
    np.save(scene / "Disp0" / "000.npy", disp)
    for name, tx in (("Extrinsics0", 0.0), ("Extrinsics1", -0.5)):
        (scene / name / "000.txt").write_text(f"1000.0 0.0 960.0\n0.0 1.0 0.0 {tx}\n")
    split = root / "split.txt"
    split.write_text("/00000/Image0/000.raw\n")
    jax_native()
    return dict(data_root=str(root), split=str(split))


@pytest.mark.parametrize("case", ["train", "train_no_bbox_norm", "consistency", "infer"])
def test_u4k_sample_equals_jax(u4k, case):
    kw = dict(u4k, transform_cfg=dict(network_process_size=[384, 512], degree=1.0,
                                      image_raw_shape=[2160, 3840]))
    kw["mode"] = "infer" if case == "infer" else "train"
    if case == "consistency":
        kw.update(consistency=True, overlap=270)
    if case == "train_no_bbox_norm":
        kw["pre_norm_bbox"] = False
    port, ref = UnrealStereo4kDataset(**kw), JU4K(**kw)
    assert len(port) == len(ref) == 1
    for seed in (1, 2) if case.startswith("train") else (1,):
        a = seeded(lambda: port[0], seed)
        b = seeded(lambda: ref[0], seed)
        assert_same_sample(a, b)
    if case == "infer":
        assert a["boundary"].any() and a["image_hr"].shape == (2160, 3840, 3)
    if case == "consistency":
        assert a["crops_image_hr"].shape == (16, 384, 512, 3)


def test_u4k_depth_factor_without_extrinsics(tmp_path):
    """Without the extrinsics files the depth factor is 1, as in JAX."""
    (tmp_path / "Disp0").mkdir()
    split = tmp_path / "split.txt"
    split.write_text("Image0/a.raw\n")
    kw = dict(mode="infer", data_root=str(tmp_path), split=str(split))
    assert UnrealStereo4kDataset(**kw).data_infos == JU4K(**kw).data_infos


def test_u4k_missing_blob_raises(tmp_path):
    """The host library's load of a missing blob raises (no fallback)."""
    with pytest.raises(OSError):
        native.load_raw_bgr_as_rgb_f32(str(tmp_path / "none.raw"))


# ----------------------------------------------------------------- Cityscapes
CS_H, CS_W = 64, 128


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """Two frames of 64x128: the image PNG, a uint16 disparity PNG (256 d +
    1, some invalid zeros), the camera json, a skyArea PNG at half size, a
    gtFine colour map with sky, and under ``pl/`` the pseudo label, its
    uncertainty and its count at half size."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(3)
    lines = []
    for i, city in enumerate(("aachen", "bremen")):
        stem = f"{city}_000000_00001{i}"
        img = f"leftImg8bit/train/{city}/{stem}_leftImg8bit.png"
        dsp = f"disparity/train/{city}/{stem}_disparity.png"
        write_png(str(root / img), rng.randint(0, 256, (CS_H, CS_W, 3), np.uint8))
        stored = (rng.uniform(2.0, 60.0, (CS_H, CS_W)) * 256.0 + 1.0).astype(np.uint16)
        stored[:4, :4] = 0
        stored[:, 40:] = 20 * 256 + 1
        write_png(str(root / dsp), stored)
        cam = root / f"camera/train/{city}/{stem}_camera.json"
        cam.parent.mkdir(parents=True, exist_ok=True)
        cam.write_text(json.dumps({"extrinsic": {"baseline": 0.22}, "intrinsic": {"fx": 2262.52}}))
        sky = np.zeros((CS_H // 2, CS_W // 2), np.uint8)
        sky[:5, 10:30] = 255
        write_png(str(root / f"skyArea/train/{city}/{stem}_skyArea.png"), sky)
        seg = rng.randint(0, 256, (CS_H, CS_W, 3)).astype(np.uint8)
        seg[2:9, 20:60] = (70, 130, 180)
        write_png(str(root / f"gtFine/train/{city}/{stem}_gtFine_color.png"), seg)
        pl = root / "pl" / f"leftImg8bit_train_{city}_{stem}_leftImg8bit"
        write_png(f"{pl}_uint16.png", (rng.uniform(1, 80, (CS_H // 2, CS_W // 2)) * 256).astype(np.uint16))
        write_png(f"{pl}_uncert_uint16.png",
                  (rng.uniform(0, 4, (CS_H // 2, CS_W // 2)) * 256).astype(np.uint16))
        write_png(f"{pl}_count_uint16.png",
                  (rng.uniform(0, 200, (CS_H // 2, CS_W // 2)) * 256).astype(np.uint16))
        lines.append(f"{img} {dsp}")
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    return dict(data_root=str(root), split=str(split), pl=str(root / "pl"))


def cs_kwargs(cs, mode, **extra):
    kw = dict(mode=mode, split=cs["split"], data_root=cs["data_root"], min_depth=1e-3, max_depth=250,
              patch_raw_shape=[16, 32],
              transform_cfg=dict(degree=1.0, network_process_size=[24, 32],
                                 image_raw_shape=[CS_H, CS_W]))
    kw.update(extra)
    return kw


@pytest.mark.parametrize("case", ["train", "train_pseudo", "train_uncert", "infer", "infer_seg"])
def test_cityscapes_sample_equals_jax(cityscapes, case):
    extra = dict(train_pseudo=dict(with_pseudo_label=True, pseudo_label_path=cityscapes["pl"]),
                 train_uncert=dict(with_pseudo_label=True, pseudo_label_path=cityscapes["pl"],
                                   with_uncert=True, filter_thr=0.5),
                 infer_seg=dict(with_seg_map=True)).get(case, {})
    kw = cs_kwargs(cityscapes, case.split("_")[0], **extra)
    port, ref = CityScapesDataset(**kw), JCityScapes(**kw)
    assert len(port) == len(ref) == 2
    for idx in (0, 1):
        for seed in (4, 5):
            a = seeded(lambda: port[idx], seed)
            b = seeded(lambda: ref[idx], seed)
            assert_same_sample(a, b)
    d = a["depth_gt"][..., 0]
    if case.startswith("train"):
        assert "seg_image" not in a and (a["crop_depths"].shape == (16, 32, 1))
        assert (d == -2.0).any() and (d == -1.0).any()  # the sky and the border marks
        assert ("pseudo_label" in a) == (case != "train")
        assert ("pseudo_uncert" in a) == (case == "train_uncert")
    else:
        assert "seg_image" not in a  # the JAX reader's quirk, kept
        assert (d[-CS_H // 4:] == -1.0).all() and a["boundary"].any()
        assert ((d == 0.0).sum() > 16) == (case == "infer_seg")  # the sky zeroed


def test_cityscapes_metric_surface_equals_jax(cityscapes):
    """``get_metrics`` of a reader's infer sample against a prediction, as
    the JAX reader's."""
    kw = cs_kwargs(cityscapes, "infer", with_seg_map=True)
    port, ref = CityScapesDataset(**kw), JCityScapes(**kw)
    s = port[0]
    pred = np.clip(s["depth_gt"][..., 0], 1.0, None) * 1.05
    got, want = port.get_metrics(s["depth_gt"], pred), ref.get_metrics(s["depth_gt"], pred)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * max(abs(v), 1e-12), (k, got[k], v)


# ----------------------------------------------------------------- transforms
def test_transforms_equal_jax():
    rng = np.random.RandomState(6)
    img = rng.rand(40, 56, 3).astype(np.float32)
    depth = (1 + 10 * rng.rand(40, 56)).astype(np.float32)
    u8 = rng.randint(0, 256, (40, 56, 3), np.uint8)
    cases = [
        ("flip", lambda m: m.aug_flip(img, [depth, None])),
        ("color", lambda m: m.aug_color(img)),
        ("rotate", lambda m: m.aug_rotate(u8, [depth, None, depth.astype(np.float64)], 5.0)),
        ("crop", lambda m: m.random_crop(img, [depth, None], (16, 24))),
    ]
    for name, fn in cases:
        for seed in range(6):
            got, want = seeded(lambda: fn(pt), seed), seeded(lambda: fn(jt), seed)
            flat_g, flat_w = _flatten(got), _flatten(want)
            assert len(flat_g) == len(flat_w), name
            for g, w in zip(flat_g, flat_w):
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype, name
                    np.testing.assert_array_equal(g, w, err_msg=name)
                else:
                    assert g == w, name


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flatten(v)]
    return [x]


@pytest.mark.parametrize("mode,align", [("bilinear", True), ("bilinear", False), ("nearest", False),
                                        ("bicubic", False)])
@pytest.mark.parametrize("size", [(17, 29), (80, 100)])
def test_resize_hwc_equals_jax(mode, align, size):
    """Bit for bit but bicubic (see the module docstring): the host
    library's path (bilinear, align_corners), the taps' paths, and nearest
    on an (H, W) map against the JAX reader's ``_nearest_resize_hw``."""
    from patchrefinerv2_tpu.datasets.cityscapes import _nearest_resize_hw

    rng = np.random.RandomState(7)
    img = rng.rand(40, 56, 3).astype(np.float32)
    got, want = pt.resize_hwc(img, size, mode, align), jt.resize_hwc(img, size, mode, align)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if mode == "bicubic":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt.resize_hwc(img[..., 0], size, "nearest", False),
                                  _nearest_resize_hw(img[..., 0], size))


# --------------------------------------------------------------------- loader
def synthetic(**kw):
    kw = dict(length=7, image_raw_shape=(32, 48), network_process_size=(8, 12),
              patch_raw_shape=(16, 24), seed=2, **kw)
    return SyntheticDataset(mode="train", **kw), JSynthetic(mode="train", **kw)


def batches(loader, epochs=(1, 2)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    return out


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same_sample(a, b)


@pytest.mark.parametrize("workers", [1, 2, 3, 16])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_jax(workers, drop_last):
    """Loaded by one thread or by a pool (16 threads: more than the cores),
    the batches and their order are the JAX loader's (its default
    prefetch), epoch after epoch."""
    port, ref = synthetic()
    kw = dict(batch_size=2, shuffle=True, seed=5, drop_last=drop_last, num_workers=workers)
    a, b = DataLoader(port, **kw), JLoader(ref, num_prefetch=DataLoader.PREFETCH, **kw)
    assert len(a) == len(b)
    assert_same_batches(batches(a), batches(b))


@pytest.mark.parametrize("batch_size", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_length_equals_jax(batch_size, drop_last):
    """``len`` is JAX's for 7 samples, and the loader yields that many
    batches, the last one short unless dropped."""
    port, ref = synthetic()
    kw = dict(batch_size=batch_size, shuffle=True, seed=5, drop_last=drop_last)
    loader = DataLoader(port, num_workers=2, **kw)
    sizes = [len(b["image_lr"]) for b in loader]
    assert len(loader) == len(JLoader(ref, **kw)) == len(sizes)
    assert sum(sizes) == (7 // batch_size * batch_size if drop_last else 7)


def test_prefetched_train_batches_draw_as_jax(cityscapes):
    """With one loader thread the readers' global-RNG draws come in batch
    order: Cityscapes train batches (rotation, colour, flip, crop) equal
    the JAX loader's from the same seeds."""
    kw = cs_kwargs(cityscapes, "train", with_pseudo_label=True, pseudo_label_path=cityscapes["pl"])
    loaders = (DataLoader(CityScapesDataset(**kw), batch_size=1, shuffle=True, seed=1),
               JLoader(JCityScapes(**kw), batch_size=1, shuffle=True, seed=1))
    got, want = (seeded(lambda: batches(ld), 11) for ld in loaders)
    assert_same_batches(got, want)


def test_loader_stops_its_threads_and_raises_errors():
    """A consumer that stops after one batch leaves no loader thread
    running; an error in a sample reaches the consumer."""
    port, _ = synthetic()
    it = iter(DataLoader(port, batch_size=1, num_workers=3))
    next(it)
    it.close()
    deadline = time.time() + 10
    while any(t.name.startswith("loader") for t in threading.enumerate()) and time.time() < deadline:
        time.sleep(0.05)
    assert not [t.name for t in threading.enumerate() if t.name.startswith("loader")]

    class Broken(SyntheticDataset):
        def __getitem__(self, idx):
            if idx == 3:
                raise OSError("unreadable frame")
            return super().__getitem__(idx)

    broken = Broken(mode="train", length=6, image_raw_shape=(32, 48), network_process_size=(8, 12),
                    patch_raw_shape=(16, 24))
    for workers in (1, 2):
        with pytest.raises(OSError, match="unreadable"):
            list(DataLoader(broken, batch_size=1, num_workers=workers))


# ------------------------------------------------------------ the host library
def test_host_library_is_the_ports_own():
    """The port builds ``csrc/dataio.cpp`` into ``_build/`` and loads
    nothing from ``native/``: in a process that runs the readers' host
    calls, the only data library mapped is the port's."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import numpy as np
from patchrefinerv2_torch.datasets import native, transforms
transforms.resize_hwc(np.zeros((8, 8, 3), np.float32), (4, 4))
maps = open("/proc/self/maps").read()
print(native.target())
print(sorted({{l.split()[-1] for l in maps.splitlines() if l.endswith(".so") and "{ROOT}" in l}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, check=True).stdout.strip().splitlines()
    target, mapped = out[-2], out[-1]
    assert target.startswith(str(ROOT / "patchrefinerv2_torch" / "_build"))
    assert target in mapped and str(ROOT / "native") not in mapped
    for path in (ROOT / "patchrefinerv2_torch").rglob("*.py"):
        text = path.read_text()
        assert "libprv2io" not in text and "native/" not in text, path


def test_host_library_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """No g++, or a source g++ refuses: the build raises (a numpy fallback
    would round the samples otherwise)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.build()
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g.. failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
