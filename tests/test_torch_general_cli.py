"""The port's ``general`` and ``gen`` test types, ``--save`` and the
``Tester`` fallbacks, on the CPU at the tiny flagship geometry of
tests/test_torch_data_cli.py (96x128 frames split 2x2 into 48x64 patches):

- ``test.main --test-type general --save`` over a folder of images (one
  resized to the frame by the bicubic path, one at its size) writes each
  image's colored and uint16 PNG, equal to what ``save_colored`` and
  ``save_raw_16bit`` make of the depth ``infer`` returns;
- the port's ``Tester`` saves as the JAX package's does, bit for bit, under
  each colormap policy (``gray_scale``, Cityscapes, the default), on the
  same depth maps (a stand-in model returns them to both);
- ``--test-type gen`` writes ``save_raw_16bit`` of the depth ``infer``
  returns at the model's own tile geometry;
- ``Tester.run`` on a dataset without ``get_metrics`` returns ``{}``, and
  on one without ``evaluate`` the nan-mean of each metric, as JAX's does;
- ``train.main`` takes one offline Semi step (``semi_eff.py``) on KITTI
  files, reading the reader's pseudo labels;
- the port's colormap tables (``utils/colormaps.py``) equal matplotlib's.

Every checkpoint a test writes is removed after it.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from patchrefinerv2_tpu.evaluation.tester import Tester as JTester
from patchrefinerv2_tpu.utils import color as jcolor

from patchrefinerv2_torch import test as evaluate  # not test_*: pytest would collect it
from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.general import ImageDataset
from patchrefinerv2_torch.evaluation.tester import Tester as PortTester
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.train import main as train_main
from patchrefinerv2_torch.utils import color, colormaps
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_slice import slice_config

ROOT = Path(__file__).resolve().parent.parent
U4K = ROOT / "configs/patchrefinerv2_zoedepth/v2_eff_u4k.py"
KITTI_SEMI = ROOT / "configs/patchrefinerv2_zoedepth_kitti/semi_eff.py"
H, W = 96, 128


def read_png(path) -> np.ndarray:
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two images: ``a.png`` at 60x80 (the bicubic path to 96x128) and
    ``b.jpg`` at 96x128."""
    import cv2

    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(5)
    cv2.imwrite(str(root / "a.png"), rng.randint(0, 256, (60, 80, 3), np.uint8))
    cv2.imwrite(str(root / "b.jpg"), rng.randint(0, 256, (H, W, 3), np.uint8))
    return root


@pytest.fixture(scope="module")
def config(folder, tmp_path_factory):
    """The flagship config with the tiny model, its ``general_dataloader``
    on the folder."""
    data = dict(rgb_image_dir=str(folder), network_process_size=[H // 2, W // 2],
                image_raw_shape=[H, W])
    path = tmp_path_factory.mktemp("cfg") / "tiny_general.py"
    path.write_text(f"""
_base_ = [{str(U4K)!r}]
model = {dict(_delete_=True, type="PatchRefinerPlus", config=slice_config())!r}
general_dataloader = dict(num_workers=1, dataset={data!r})
""")
    return str(path)


def infer_folder(config):
    """The depth ``infer`` returns (m1, process_num 4) for each image of the
    config's folder, by name, on a model built as the entry point builds it."""
    cfg = Config.fromfile(config)
    model = build_model(cfg.model, device="cpu", seed=0)
    ds = ImageDataset(**{k: v for k, v in cfg.general_dataloader.dataset.items() if k != "type"})
    out = {}
    for i in range(len(ds)):
        s = ds[i]
        depth, _ = model.infer(s["image_lr"][None], s["image_hr"][None], cai_mode="m1", process_num=4)
        out[s["img_file_basename"]] = depth.numpy()
    return out


def test_general_save_writes_each_image(config, tmp_path):
    wd = tmp_path / "out"
    got = evaluate.main([config, "--test-type", "general", "--save", "--work-dir", str(wd),
                         "--device", "cpu"])
    assert got == {}  # no ground truth
    depths = infer_folder(config)
    assert sorted(depths) == ["a", "b"]
    assert sorted(p.name for p in wd.iterdir()) == ["a.png", "a_uint16.png", "b.png", "b_uint16.png"]
    for name, depth in depths.items():
        color.save_raw_16bit(depth, str(tmp_path / "raw.png"))
        color.save_colored(depth, str(tmp_path / "col.png"), "Spectral", 0, 100)
        assert read_png(wd / f"{name}_uint16.png").dtype == np.uint16
        np.testing.assert_array_equal(read_png(wd / f"{name}_uint16.png"), read_png(tmp_path / "raw.png"))
        np.testing.assert_array_equal(read_png(wd / f"{name}.png"), read_png(tmp_path / "col.png"))
        assert read_png(wd / f"{name}.png").shape == (H, W, 3)


def test_gen_writes_the_inferred_depth(config, tmp_path):
    wd = tmp_path / "pl"
    out = evaluate.main([config, "--test-type", "gen", "--work-dir", str(wd), "--device", "cpu"])
    assert out == {"pseudo_labels": [str(wd / "a_uint16.png"), str(wd / "b_uint16.png")]}
    for name, depth in infer_folder(config).items():
        np.testing.assert_array_equal(read_png(wd / f"{name}_uint16.png"),
                                      (depth.astype(np.float64) * 256).astype(np.uint16))


class StandIn:
    """A model whose ``infer`` returns the next of ``depths``, for the port
    (a tensor) or the JAX Tester (an array)."""

    def __init__(self, depths, as_tensor):
        self.depths, self.as_tensor, self.i = depths, as_tensor, 0

    def infer(self, *args, **kwargs):
        d = self.depths[self.i % len(self.depths)]
        self.i += 1
        return (torch.from_numpy(d) if self.as_tensor else d), None


class Loader:
    def __init__(self, batches, dataset):
        self.batches, self.dataset = batches, dataset

    def __iter__(self):
        return iter(self.batches)


class Named:
    """A dataset with only a name (no ``get_metrics``, no ``evaluate``)."""

    def __init__(self, name=""):
        self.dataset_name = name


def stand_in_batches(n, gt=False):
    rng = np.random.RandomState(8)
    batches = []
    for i in range(n):
        b = {"image_lr": np.zeros((1, 4, 4, 3), np.float32), "image_hr": np.zeros((1, 8, 8, 3), np.float32),
             "img_file_basename": [f"frame{i}"]}
        if gt:
            b["depth_gt"] = rng.uniform(1, 20, (1, 24, 32, 1)).astype(np.float32)
        batches.append(b)
    return batches


def stand_in_depths(n):
    rng = np.random.RandomState(9)
    depths = [rng.uniform(0.5, 30.0, (24, 32)).astype(np.float32) for _ in range(n)]
    depths[0][:, :5] = 0.0  # a flat band: percentiles at the edge of the range
    return depths


@pytest.mark.parametrize("policy", ["gray_scale", "cityscapes", "default"])
def test_tester_saves_as_jax(tmp_path, policy):
    depths = stand_in_depths(2)
    ds_name = "cityscapes" if policy == "cityscapes" else "kitti"
    kw = dict(save=True, gray_scale=policy == "gray_scale")
    port = PortTester({}, StandIn(depths, True), Loader(stand_in_batches(2), Named(ds_name)),
                  work_dir=str(tmp_path / "port"), **kw)
    ref = JTester({}, StandIn(depths, False), Loader(stand_in_batches(2), Named(ds_name)),
                  work_dir=str(tmp_path / "jax"), **kw)
    assert port.cmap == ref.cmap == {"gray_scale": "gray_r", "cityscapes": "magma_r",
                                     "default": "Spectral"}[policy]
    assert port.run() == ref.run(None) == {}
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(files) == 4
    for f in files:
        a, b = read_png(tmp_path / "port" / f), read_png(tmp_path / "jax" / f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_save_functions_equal_jax(tmp_path):
    """``save_raw_16bit`` and ``save_colored`` on the same arrays, each
    colormap with its percentiles, bit for bit."""
    for i, depth in enumerate(stand_in_depths(2)):
        color.save_raw_16bit(depth, str(tmp_path / "p.png"))
        jcolor.save_raw_16bit(depth, str(tmp_path / "j.png"))
        np.testing.assert_array_equal(read_png(tmp_path / "p.png"), read_png(tmp_path / "j.png"))
        for cmap, lo, hi in (("gray_r", 2, 95), ("magma_r", 0, 100), ("Spectral", 0, 100)):
            color.save_colored(depth, str(tmp_path / "p.png"), cmap, lo, hi)
            jcolor.save_colored(depth, str(tmp_path / "j.png"), cmap, vminp=lo, vmaxp=hi)
            np.testing.assert_array_equal(read_png(tmp_path / "p.png"), read_png(tmp_path / "j.png"))


@pytest.mark.parametrize("name", sorted(colormaps._TABLES))
def test_colormap_tables_equal_matplotlib(name):
    """Each table is matplotlib's, and ``apply`` colors as its
    ``Colormap.__call__(..., bytes=True)``: 0 and 1 exactly, under, over and
    NaN, in float32 and float64."""
    import matplotlib

    cmap = matplotlib.colormaps[name]
    cmap._init()
    np.testing.assert_array_equal(colormaps.lut(name), (cmap._lut * 255).astype(np.uint8))
    rng = np.random.RandomState(12)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 4000), [0.0, 1.0, np.nan, -1e-9, 1 + 1e-7]])
    for dt in (np.float32, np.float64):
        v = x.astype(dt).reshape(5, -1)
        np.testing.assert_array_equal(colormaps.apply(name, v), cmap(v, bytes=True))


class MetricsOnly:
    """A dataset with ``get_metrics`` (one metric NaN on the first image)
    and no ``evaluate``."""

    dataset_name = ""

    def __init__(self):
        self.calls = 0

    def get_metrics(self, depth_gt, result, **kwargs):
        self.calls += 1
        err = float(np.abs(np.asarray(result).mean() - np.asarray(depth_gt).mean()))
        return {"err": err, "maybe": float("nan") if self.calls == 1 else err * 2}


def test_tester_fallbacks_equal_jax(tmp_path):
    depths = stand_in_depths(3)
    batches = stand_in_batches(3, gt=True)
    none = [PortTester({}, StandIn(depths, True), Loader(batches, Named())).run(),
            JTester({}, StandIn(depths, False), Loader(batches, Named()), work_dir=str(tmp_path)).run(None)]
    assert none == [{}, {}]  # ground truth, but no get_metrics
    got = PortTester({}, StandIn(depths, True), Loader(batches, MetricsOnly())).run()
    want = JTester({}, StandIn(depths, False), Loader(batches, MetricsOnly()), work_dir=str(tmp_path)).run(None)
    assert sorted(got) == sorted(want) == ["err", "maybe"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert np.isfinite(got["maybe"])  # the nan-mean skips the NaN


@pytest.fixture
def wd(tmp_path):
    """A work dir, removed after the test (a checkpoint holds the B5 refiner
    and its optimizer state)."""
    yield tmp_path / "wd"
    shutil.rmtree(tmp_path / "wd", ignore_errors=True)


def test_offline_kitti_semi_step_reads_the_pseudo_labels(tmp_path, wd):
    """``semi_eff.py`` with the tiny student over two KITTI frames at the
    tiny size (no KB crop), their pseudo labels named by the reader's rule
    from the image paths: one step, a finite edge loss that is not 0."""
    from PIL import Image

    rng = np.random.RandomState(10)
    root, pl = tmp_path / "kitti", tmp_path / "pl"
    lines = []
    for i in range(2):
        img, dep = f"drive/image_02/data/{i:010d}.png", f"drive/proj_depth/{i:010d}.png"
        for rel, arr in ((img, rng.randint(0, 256, (H, W, 3), np.uint8)),
                         (dep, np.where(rng.rand(H, W) < 0.3, rng.uniform(1, 80, (H, W)) * 256, 0)
                          .astype(np.uint16))):
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(arr).save(root / rel)
        pl.mkdir(exist_ok=True)
        d = np.kron(rng.uniform(2, 60, (4, 4)), np.ones((H // 4, W // 4)))
        Image.fromarray((d * 256).astype(np.uint16)).save(pl / img.replace("/", "_").replace(".png", "_uint16.png"))
        lines.append(f"{img} {dep} 721.5377")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    student = dict(type="PatchRefinerPlus", config=slice_config())
    model = dict(_delete_=True, type="PatchRefinerSemi", model_cfg_student=student,
                 model_cfg_teacher=None, edgeloss=dict(type="ScaleAndShiftInvariantLoss",
                                                       only_missing_area=False, grad_matching=False))
    data = dict(data_root=str(root), split=str(root / "split.txt"), do_kb_crop=False,
                pseudo_label_path=str(pl), patch_raw_shape=[H // 2, W // 2],
                transform_cfg=dict(network_process_size=[H // 2, W // 2], image_raw_shape=[H, W]))
    config = tmp_path / "tiny_semi_kitti.py"
    config.write_text(f"""
_base_ = [{str(KITTI_SEMI)!r}]
model = {model!r}
train_dataloader = dict(batch_size=2, num_workers=1, dataset={data!r})
val_dataloader = None
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1, train_log_img_interval=0)
""")
    cfg = Config.fromfile(str(config))
    assert cfg.train_dataloader.dataset.type == "KittiDataset"
    assert cfg.train_dataloader.dataset.with_pseudo_label
    train_main([str(config), "--work-dir", str(wd), "--device", "cpu", "--seed", "3"])
    rows = [json.loads(r) for r in (wd / "metrics.jsonl").read_text().splitlines()]
    edge = [r["edge_loss"] for r in rows if "edge_loss" in r]
    assert len(edge) == 1 and np.isfinite(edge[0]) and edge[0] != 0.0
