"""The port's entry points on files, on the CPU: ``patchrefinerv2_torch.train``
and ``patchrefinerv2_torch.test`` read a small Cityscapes directory the
fixture writes (96x128 frames: image, disparity, camera json, sky, gtFine
colour map, offline pseudo labels) with the tiny flagship topology of
tests/test_torch_slice.py put into the repository's Cityscapes configs.

- ``train.main``: one step of stage 3 (``plus_eff_cs_pretrain.py``) with
  its m1 validation on the reader's infer frames and a checkpoint; one step
  of the offline Semi transfer (``plus_eff_cs_semi_offline_ssigm_ft.py``),
  whose edge loss reads the reader's ``pseudo_label`` though the config's
  ``collect_input_args`` leave it out; a missing validation split is
  skipped.
- ``test.main`` with that checkpoint gives ``Tester.run``'s aggregate on
  the same model and frames, bit for bit; a checkpoint tensor the model
  cannot take raises; without ``--device cpu`` it needs a card;
  ``--test-type benchmark`` prints the fps and the complexity with JAX's
  keys (but XLA's ``bytes_accessed``) and writes ``benchmark.txt``.
- UnrealStereo4K: one stage-3 step of ``v2_eff_u4k.py`` on a 2160x3840
  frame the test writes, and ``test.main``'s m1 evaluation of its
  checkpoint on the config's test loader (the same frame): finite metrics,
  the boundary's soft edge error among them; ``--test-type consistency``
  on that frame (the config's consistency loader, the 16 crops of its 4x4
  grid) prints ``Tester.run_consistency``'s error on the same loader.
"""

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch import test as evaluate  # not test_*: pytest would collect it
from patchrefinerv2_torch.evaluation.tester import Tester as PortTester
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.train import build_dataset, main as train_main
from patchrefinerv2_torch.utils.checkpoint import load_checkpoint
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_slice import slice_config

CS = Path("configs/patchrefinerv2_zoedepth_cs").resolve()
U4K = Path("configs/patchrefinerv2_zoedepth/v2_eff_u4k.py").resolve()
H, W = 96, 128


def write_png(path: Path, arr):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def cs_dir(tmp_path_factory):
    """Two Cityscapes frames at 96x128 with a disparity that steps (so that
    the boundary and the prediction's metrics have edges to see)."""
    root = tmp_path_factory.mktemp("cs_cli")
    rng = np.random.RandomState(0)
    lines = []
    for i in range(2):
        stem = f"city_000000_00000{i}"
        img, dsp = (f"leftImg8bit/val/city/{stem}_leftImg8bit.png",
                    f"disparity/val/city/{stem}_disparity.png")
        write_png(root / img, rng.randint(0, 256, (H, W, 3), np.uint8))
        disp = np.where(np.arange(W)[None, :] < 60, 30.0, 8.0) + rng.uniform(0, 1, (H, W))
        write_png(root / dsp, (disp * 256 + 1).astype(np.uint16))
        cam = root / f"camera/val/city/{stem}_camera.json"
        cam.parent.mkdir(parents=True, exist_ok=True)
        cam.write_text(json.dumps({"extrinsic": {"baseline": 0.22}, "intrinsic": {"fx": 2262.52}}))
        sky = np.zeros((H, W), np.uint8)
        sky[:6, :40] = 1
        write_png(root / f"skyArea/val/city/{stem}_skyArea.png", sky)
        seg = np.zeros((H, W, 3), np.uint8)
        seg[:, 60:] = (128, 64, 128)
        seg[:4] = (70, 130, 180)
        write_png(root / f"gtFine/val/city/{stem}_gtFine_color.png", seg)
        pl = root / "pl" / f"leftImg8bit_val_city_{stem}_leftImg8bit_uint16.png"
        write_png(pl, (rng.uniform(5, 60, (H, W)) * 256).astype(np.uint16))
        lines.append(f"{img} {dsp}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return root


def tiny_model() -> dict:
    cfg = slice_config()
    cfg["patch_raw_shape"] = [H // 2, W // 2]
    return cfg


def write_config(tmp_path: Path, base: str, root: Path, model: dict, **extra) -> str:
    """A config on ``base`` with the tiny model and the readers pointed at
    ``root`` (48x64 crops and process size, 96x128 frames)."""
    data = dict(data_root=str(root), split=str(root / "split.txt"), patch_raw_shape=[H // 2, W // 2],
                transform_cfg=dict(network_process_size=[H // 2, W // 2], image_raw_shape=[H, W]))
    text = f"""
_base_ = [{str(CS / base)!r}]
model = {dict(_delete_=True, **model)!r}
train_dataloader = dict(batch_size=2, num_workers=2, dataset={data!r})
val_dataloader = dict(dataset={data!r})
train_cfg = dict(max_epochs=1, val_interval=1, log_interval=1, save_checkpoint_interval=1,
                 train_log_img_interval=0, val_log_img_interval=0)
"""
    for k, v in extra.items():
        text += f"{k} = {v!r}\n"
    path = tmp_path / f"tiny_{base}"
    path.write_text(text)
    return str(path)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test with what it wrote."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def wd(tmp_path):
    """A work dir, removed after the test: each checkpoint holds the B5
    refiner and its optimizer state (0.77 GB), and pytest keeps the temp
    dirs of three runs."""
    yield tmp_path / "wd"
    shutil.rmtree(tmp_path / "wd", ignore_errors=True)


@pytest.fixture(scope="module")
def trained(cs_dir, tmp_path_factory):
    """One stage-3 step through ``train.main`` on the reader's frames, with
    the m1 validation of the epoch; yields (config, work dir)."""
    tmp = tmp_path_factory.mktemp("cs_train")
    config = write_config(tmp, "plus_eff_cs_pretrain.py", cs_dir,
                          dict(type="PatchRefinerPlus", config=tiny_model()))
    wd = tmp / "wd"
    train_main([config, "--work-dir", str(wd), "--device", "cpu", "--seed", "3"])
    yield config, wd
    shutil.rmtree(wd, ignore_errors=True)


def test_train_cli_reads_cityscapes(trained):
    config, wd = trained
    cfg = Config.fromfile(config)
    assert cfg.train_dataloader.dataset.type == "CityScapesDataset"
    assert (wd / "checkpoint_01").exists()
    rows = [json.loads(r) for r in (wd / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "total_loss" in r]
    val_rows = [r for r in rows if "Val/abs_rel" in r]
    assert len(train_rows) == 1 and np.isfinite(train_rows[0]["total_loss"])
    assert len(val_rows) == 1 and all(np.isfinite(v) for k, v in val_rows[0].items()
                                      if k.startswith("Val/"))


def test_test_cli_equals_tester_run(trained, tmp_path):
    """``test.main`` (the config's Cityscapes val frames, the checkpoint by
    ``--ckp-path``) gives ``Tester.run``'s aggregate on a model built and
    loaded alike, bit for bit."""
    config, wd = trained
    ckpt = str(wd / "checkpoint_01")
    # the Cityscapes configs inherit the flagship's UnrealStereo4K test loader,
    # which the entry point reads first (as tools/test.py does): take the val one
    got = evaluate.main([config, "--ckp-path", ckpt, "--device", "cpu", "--cai-mode", "m1",
                         "--process-num", "4", "--cfg-option", "test_in_dataloader=None"])
    cfg = Config.fromfile(config)
    model = build_model(cfg.model, device="cpu", seed=0)
    assert evaluate.load_weights(model, ckpt) == len(model.net.state_dict())
    ds = build_dataset(cfg.val_dataloader.dataset)
    assert "seg_image" not in ds[0]  # the JAX reader's quirk: no boundary F1 from the reader
    want = PortTester(cfg, model, DataLoader(ds)).run(
        cai_mode="m1", process_num=4, image_raw_shape=(H, W), patch_split_num=(2, 2))
    assert got == want and len(want) == 10 and all(np.isfinite(v) for v in want.values())


def test_offline_semi_step_takes_the_readers_pseudo_label(cs_dir, tmp_path, wd):
    """The offline transfer config's ``collect_input_args`` leave out
    ``pseudo_label``; the model's ``batch_keys`` keep it, and the edge loss
    is finite and not zero."""
    student = dict(type="PatchRefinerPlus", config=tiny_model())
    model = dict(type="PatchRefinerSemi", model_cfg_student=student, model_cfg_teacher=None,
                 edgeloss=dict(type="ScaleAndShiftInvariantLoss", only_missing_area=False,
                               grad_matching=True))
    config = write_config(tmp_path, "plus_eff_cs_semi_offline_ssigm_ft.py", cs_dir, model)
    cfg = Config.fromfile(config)
    assert "pseudo_label" not in cfg.collect_input_args and cfg.train_dataloader.dataset.with_pseudo_label
    train_main([config, "--work-dir", str(wd), "--device", "cpu", "--seed", "3", "--cfg-option",
                f"train_dataloader.dataset.pseudo_label_path={cs_dir / 'pl'}", "val_dataloader=None"])
    rows = [json.loads(r) for r in (wd / "metrics.jsonl").read_text().splitlines()]
    edge = [r["edge_loss"] for r in rows if "edge_loss" in r]
    assert len(edge) == 1 and np.isfinite(edge[0]) and edge[0] != 0.0


def test_train_cli_skips_a_missing_validation_split(cs_dir, tmp_path, wd):
    """A validation split that is not there (``OSError``) skips validation:
    the epoch trains and saves, and no validation row is logged."""
    config = write_config(tmp_path, "plus_eff_cs_pretrain.py", cs_dir,
                          dict(type="PatchRefinerPlus", config=tiny_model()))
    train_main([config, "--work-dir", str(wd), "--device", "cpu", "--cfg-option",
                f"val_dataloader.dataset.split={tmp_path / 'no_split.txt'}"])
    rows = [json.loads(r) for r in (wd / "metrics.jsonl").read_text().splitlines()]
    assert (wd / "checkpoint_01").exists() and len(rows) == 1 and "total_loss" in rows[0]


def test_test_cli_raises_for_a_checkpoint_that_does_not_fit(trained, tmp_path):
    """A ``--ckp-path`` tensor the model lacks, or holds in another shape,
    raises instead of leaving the model's random weights in its place."""
    config, _ = trained
    state = build_model(Config.fromfile(config).model, device="cpu", seed=0).net.state_dict()
    name, weight = next((k, v) for k, v in state.items() if v.ndim == 4)
    for bad in ({name: weight.flatten()}, {"no.such.tensor": torch.zeros(1)}):
        path = tmp_path / "bad.pt"
        torch.save({"state_dict": bad}, path)
        with pytest.raises(ValueError, match="1 of its .* tensors do not fit"):
            evaluate.main([config, "--ckp-path", str(path), "--device", "cpu",
                           "--cfg-option", "test_in_dataloader=None"])


def test_test_cli_needs_a_card_without_device_cpu(trained):
    """Without ``--device cpu`` the entry point runs on the card, and raises
    where there is none."""
    config, _ = trained
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main([config])


def test_test_cli_benchmark(trained, tmp_path, capsys):
    """``--test-type benchmark`` on the first val frame: ``Tester.benchmark``
    then ``model_complexity``, one JSON line of both."""
    config, _ = trained
    out = evaluate.main([config, "--device", "cpu", "--test-type", "benchmark", "--bench-iters", "2",
                         "--bench-warmup", "1", "--bench-repeats", "2", "--work-dir", str(tmp_path),
                         "--cfg-option", "test_in_dataloader=None"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and sorted(out) == ["benchmark", "complexity"]
    assert sorted(out["benchmark"]) == ["fps", "fps_variance"] and out["benchmark"]["fps"] > 0
    assert sorted(out["complexity"]) == ["flops", "params"] and out["complexity"]["flops"] > 0
    model = build_model(Config.fromfile(config).model, device="cpu", seed=0)
    assert out["complexity"]["params"] == sum(p.numel() for p in model.net.parameters())
    lines = (tmp_path / "benchmark.txt").read_text().splitlines()
    assert lines[:2] == ["cai_mode: m1", "process_num: 4"]
    assert lines[2] == f"fps_mean: {out['benchmark']['fps']:.6f}"


def write_u4k(tmp_path: Path) -> dict:
    """One UnrealStereo4K frame (2160x3840) under ``tmp_path/data`` and its
    split; returns the readers' options (48x64 process size)."""
    rng = np.random.RandomState(1)
    scene = tmp_path / "data" / "00000"
    for d in ("Image0", "Disp0", "Extrinsics0", "Extrinsics1"):
        (scene / d).mkdir(parents=True)
    rng.randint(0, 256, (2160, 3840, 3), np.uint8).tofile(scene / "Image0" / "000.raw")
    disp = np.where(np.arange(3840)[None, :] < 1500, 40.0, 10.0) + rng.uniform(0, 1, (2160, 3840))
    np.save(scene / "Disp0" / "000.npy", disp.astype(np.float32))
    for name, tx in (("Extrinsics0", 0.0), ("Extrinsics1", -0.1)):
        (scene / name / "000.txt").write_text(f"1000.0 0.0 960.0\n0.0 1.0 0.0 {tx}\n")
    (tmp_path / "split.txt").write_text("/00000/Image0/000.raw\n")
    return dict(data_root=str(tmp_path / "data"), split=str(tmp_path / "split.txt"),
                transform_cfg=dict(network_process_size=[H // 2, W // 2]))


def u4k_config(tmp_path: Path, data: dict) -> Path:
    """``v2_eff_u4k.py`` with the tiny flagship at the 4K tiling and every
    loader on ``data``."""
    model = slice_config()
    model.update(image_raw_shape=[2160, 3840], patch_raw_shape=[540, 960], patch_split_num=[4, 4])
    consistency = dict(data, transform_cfg=dict(data["transform_cfg"], image_raw_shape=[2160, 3840]))
    config = tmp_path / "tiny_u4k.py"
    config.write_text(f"""
_base_ = [{str(U4K)!r}]
model = {dict(_delete_=True, type="PatchRefinerPlus", config=model)!r}
train_dataloader = dict(batch_size=1, num_workers=2, dataset={data!r})
val_dataloader = None
test_in_dataloader = dict(dataset={data!r})
val_consistency_dataloader = dict(num_workers=1, dataset={consistency!r})
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1, train_log_img_interval=0)
""")
    return config


def test_u4k_train_and_test_cli(tmp_path, wd, monkeypatch):
    config = u4k_config(tmp_path, write_u4k(tmp_path))
    train_main([str(config), "--work-dir", str(wd), "--device", "cpu", "--seed", "3"])
    rows = [json.loads(r) for r in (wd / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["total_loss"])
    taken, load = [], evaluate.load_weights
    monkeypatch.setattr(evaluate, "load_weights", lambda m, p: taken.append(load(m, p)) or taken[-1])
    got = evaluate.main([str(config), "--ckp-path", str(wd / "checkpoint_01"), "--device", "cpu",
                         "--process-num", "16"])
    # every tensor of the checkpoint taken, none skipped
    assert taken == [len(load_checkpoint(str(wd / "checkpoint_01"))["state_dict"])]
    assert len(got) == 10 and "see" in got and all(np.isfinite(v) for v in got.values())


def test_u4k_consistency_cli(tmp_path, capsys):
    """``--test-type consistency`` on the UnrealStereo4K frame (its
    augmentations drawn after the entry point's seeds) prints the error that
    ``Tester.run_consistency`` gives on the same loader and model."""
    config = u4k_config(tmp_path, write_u4k(tmp_path))
    got = evaluate.main([str(config), "--device", "cpu", "--test-type", "consistency"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"metrics": got}
    cfg = Config.fromfile(str(config))
    random.seed(621)
    np.random.seed(621)
    model = build_model(cfg.model, device="cpu", seed=0)
    ds = build_dataset(cfg.val_consistency_dataloader.dataset)
    assert ds.consistency and ds.overlap == 270 and len(ds) == 1
    want = PortTester(cfg, model, DataLoader(ds)).run_consistency(process_num=4)
    assert got == want and np.isfinite(got["consistency"]) and got["consistency"] > 0
