"""The Depth-Anything-V2 training configs through the port's training entry
point (``python -m patchrefinerv2_torch.train``, its ``main``), on the CPU at
tiny geometry, and their optimizer settings at full width.

The configs: the refiner pretraining (``pretrain_eff_m0s1.py``,
``pretrain_mobile_m0s1.py``), stage 3 (``plus_eff_u4k.py``,
``plus_eff_u4k_base_coarse_e2e_c2f_pretrain.py``,
``plus_mobile_u4k_base_coarse_e2e_c2f_pretrain.py``,
``plus_eff_kitti_base_coarse_e2e_c2f_pretrain.py``), the Semi transfer
``semi_kitti.py`` (all under ``configs/patchrefinerv2_dav2/``) and V1
``configs/patchrefiner_dav2/pr_u4k.py``.

- At full width, built on the meta device (no random init there): each
  config's model, and the update scale ``Trainer``'s optimizer gives each
  parameter (``optim.param_scales`` with the Trainer's frozen prefixes): the
  ``coarse_branch`` ``lr_mult`` of 0.1 reaches every DINOv2 and DPT leaf of
  a stage-3 config; V1's coarse branch is frozen and its fine DINOv2 takes
  ``refiner_fine_branch.pretrained``'s 1/30; under Semi the configs'
  prefixes match no name (``student.`` comes first), as in the JAX package.
- Through ``main`` with ``--device cpu``, one step of batch 2 each, at a
  ``vitt`` DINOv2 (64 features) and 56x84 patches (V1 also a narrow
  FusionUnet): the U4K configs on SyntheticDataset frames of 112x168, the
  KITTI ones on two KITTI frames written by
  tests/test_torch_datasets_more.py's fixture (their crops at 56x84, the
  Semi student on the fixture's offline pseudo labels), which then validate
  on a 54x86 ``image_lr`` that the Depth-Anything resizer rounds to the
  patches' 56x84 (their val loaders' own 384x512 cannot run with their
  patches, in the JAX package neither: tests/test_torch_da2.py). The hand-offs: stage 3's ``pretrained`` is a
  pretraining checkpoint, V1's ``pretrain_coarse_model`` and
  ``pretrain_fine_model`` a DA2 stage-1 (BaselinePretrain) checkpoint. The
  step's loss is finite, the validation's metrics finite; what trains
  moves, and the coarse branch does not where it is frozen (V1, and
  ``plus_eff_u4k.py`` with ``e2e_training`` set off).
- Through ``python -m patchrefinerv2_torch.test``'s ``main``: the ``normal``
  type on the KITTI frames and ``general --save`` on a folder, each
  frame's 54x86 ``image_lr`` rounded by the resizer.
"""

import json
import math
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from patchrefinerv2_torch import test as evaluate  # not test_*: pytest would collect it
from patchrefinerv2_torch import train as train_cli
from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models import patchrefinerplus as prp
from patchrefinerv2_torch.models.baseline_pretrain import BaselinePretrain
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.training.optim import param_scales
from patchrefinerv2_torch.training.trainer import Trainer
from patchrefinerv2_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_datasets_more import kitti  # noqa: F401 (fixture: two KITTI frames)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DAV2 = "configs/patchrefinerv2_dav2/"
CONFIGS = [DAV2 + "pretrain_eff_m0s1.py", DAV2 + "pretrain_mobile_m0s1.py", DAV2 + "plus_eff_u4k.py",
           DAV2 + "plus_eff_u4k_base_coarse_e2e_c2f_pretrain.py",
           DAV2 + "plus_mobile_u4k_base_coarse_e2e_c2f_pretrain.py",
           DAV2 + "plus_eff_kitti_base_coarse_e2e_c2f_pretrain.py", DAV2 + "semi_kitti.py",
           "configs/patchrefiner_dav2/pr_u4k.py"]
TINY_DA2 = dict(type="DA2", model_cfg=dict(encoder="vitt", features=64))


def frozen_of(model) -> tuple:
    """The prefixes ``Trainer`` freezes for ``model``."""
    return () if model.config.get("e2e_training", False) or model.pretrain_stage else ("coarse_branch",)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_da2_config_builds_with_its_lr_mult(path, monkeypatch):
    monkeypatch.setattr(prp, "init_random_", lambda net, generator: net)
    cfg = Config.fromfile(str(ROOT / path))
    with torch.device("meta"):
        model = build_model(cfg.model, device="meta")
    names = [n for n, _ in model.net.named_parameters()]
    scales = param_scales(names, cfg.optim_wrapper.paramwise_cfg.custom_keys, frozen_of(model))
    coarse = [n for n in names if n.startswith("coarse_branch.")]
    if "pretrain_" in path:
        assert model.pretrain_stage and not coarse and model.net.hack_chl[-1] == 128
        assert all(scales[n] == 0.1 for n in names if n.startswith("refiner_fine_branch.refiner_encoder."))
    elif path.endswith("semi_kitti.py"):
        student = model.student
        assert student.resizer_da and not student.net.e2e_training and student.net.remat
        assert set(scales.values()) == {1.0}  # the JAX package's prefixes match at the root only
    elif path.endswith("pr_u4k.py"):
        fine = [n for n in names if n.startswith("refiner_fine_branch.pretrained.")]
        assert model.resizer_da and coarse and fine
        assert all(scales[n] == 0.0 for n in coarse)
        assert all(scales[n] == pytest.approx(1 / 30) for n in fine)
    else:
        assert model.resizer_da and model.net.e2e_training
        trunk = [n for n in coarse if n.startswith("coarse_branch.pretrained.")]
        head = [n for n in coarse if n.startswith("coarse_branch.depth_head.")]
        assert len(trunk) + len(head) == len(coarse) and trunk and head
        assert all(scales[n] == 0.1 for n in coarse)
        # DINOv2-L (24 blocks of width 1024) with the DPT head of 256 features
        assert model.net.coarse_branch.pretrained.pos_embed.shape == (1, 1370, 1024)
        assert len(model.net.coarse_branch.pretrained.blocks) == 24


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test (checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


SYNTHETIC = dict(type="SyntheticDataset", mode="train", length=2, image_raw_shape=[112, 168],
                 network_process_size=[56, 84], patch_raw_shape=[56, 84])
TRAIN_CFG = dict(max_epochs=1, log_interval=1, val_interval=1, eval_start=0, save_checkpoint_interval=1,
                 train_log_img_interval=0, val_log_img_interval=0)
U4K = dict(image_raw_shape=[112, 168], patch_process_shape=[56, 84], patch_split_num=[2, 2])


def tiny_model(path: str, handoff: dict) -> dict:
    """The ``model`` overrides of a config at tiny geometry."""
    if path.endswith("semi_kitti.py"):
        return dict(model_cfg_student=dict(config=dict(patch_process_shape=[56, 84],
                                                       coarse_branch=TINY_DA2)))
    if path.endswith("pr_u4k.py"):
        return dict(config=dict(
            U4K, coarse_branch=TINY_DA2, refiner=dict(fine_branch=TINY_DA2, fusion_model=dict(
                temp_chl=[16, 32, 32, 32, 32, 32], dec_chl=[32, 32, 32, 32, 16])),
            pretrain_coarse_model=handoff["stage1"], pretrain_fine_model=handoff["stage1"]))
    geo = dict(patch_process_shape=[56, 84]) if "kitti" in path else U4K
    cfg = dict(geo, coarse_branch=TINY_DA2)
    if path.endswith("e2e_c2f_pretrain.py") and "kitti" not in path:
        cfg["pretrained"] = handoff["pretrain_" + ("mobile" if "mobile" in path else "eff")]
    return dict(config=cfg)


def loaders(path: str, kitti: dict) -> dict:  # noqa: F811 (the fixture's value)
    if "kitti" not in path:
        return dict(train_dataloader=dict(batch_size=2, num_workers=1, dataset=SYNTHETIC),
                    val_dataloader=None)
    ds = dict(data_root=kitti["data_root"], split=kitti["split"])
    train = dict(ds, transform_cfg=dict(network_process_size=[56, 84]))
    if path.endswith("semi_kitti.py"):
        train.update(with_pseudo_label=True, pseudo_label_path=kitti["pl"])
    # a 54x86 image_lr, which the resizer rounds to the 56x84 patches (the
    # configs' 384x512 cannot run: tests/test_torch_da2.py)
    val = dict(ds, transform_cfg=dict(network_process_size=[54, 86]))
    return dict(train_dataloader=dict(batch_size=2, num_workers=1, dataset=train),
                val_dataloader=dict(dataset=val))


@pytest.fixture(scope="module")
def handoff(tmp_path_factory):
    """The checkpoints the hand-offs name: each pretraining config's network
    at tiny geometry (``pretrained`` of the e2e_c2f stage-3 configs) and a
    ``vitt`` DA2 BaselinePretrain's (V1's ``pretrain_coarse_model`` and
    ``pretrain_fine_model``), random weights from seed 3."""
    root = tmp_path_factory.mktemp("handoff")
    out = {}
    for name in ("eff", "mobile"):
        cfg = Config.fromfile(str(ROOT / DAV2 / f"pretrain_{name}_m0s1.py")).model.config.to_dict()
        cfg.update(U4K, coarse_branch=TINY_DA2)
        out[f"pretrain_{name}"] = str(root / f"pretrain_{name}")
        net = PatchRefinerPlus(cfg, device="cpu", seed=3).net
        save_checkpoint(out[f"pretrain_{name}"], {"state_dict": net.state_dict(), "epoch": 1, "step": 1})
    stage1 = BaselinePretrain(dict(target="coarse", coarse_branch=TINY_DA2, patch_process_shape=[56, 84]),
                              device="cpu", seed=3)
    out["stage1"] = str(root / "stage1")
    save_checkpoint(out["stage1"], {"state_dict": stage1.net.state_dict(), "epoch": 1, "step": 1})
    yield out
    shutil.rmtree(root, ignore_errors=True)


CASES = [(p, True) for p in CONFIGS] + [(DAV2 + "plus_eff_u4k.py", False)]


@pytest.mark.parametrize("path,e2e", CASES, ids=[os.path.basename(p) + ("" if e else "-e2e_off")
                                                 for p, e in CASES])
def test_da2_config_trains_through_the_cli(path, e2e, tmp_path, handoff, kitti, monkeypatch):  # noqa: F811
    cfg_path = tmp_path / "tiny.py"
    model = tiny_model(path, handoff)
    if not e2e:
        model["config"]["e2e_training"] = False
    over = dict(model=model, train_cfg=TRAIN_CFG, **loaders(path, kitti))
    cfg_path.write_text(f"_base_ = [{str(ROOT / path)!r}]\n"
                        + "".join(f"{k} = {v!r}\n" for k, v in over.items()))
    trainers = []

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)
            self.initial = {n: p.detach().clone() for n, p in self.model.net.named_parameters()}

        def save(self, epoch):  # no checkpoint: the weights are read in memory
            return None

    monkeypatch.setattr(train_cli, "Trainer", Recorded)
    wd = tmp_path / "wd"
    train_cli.main([str(cfg_path), "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    (tr,) = trainers
    lines = [json.loads(x) for x in (wd / "metrics.jsonl").read_text().splitlines()]
    steps = [x for x in lines if "total_loss" in x]
    assert len(steps) == 1 and math.isfinite(steps[0]["total_loss"])
    val = [x for x in lines if any(k.startswith("Val/") for k in x)]
    if "kitti" in path:  # two frames
        assert len(val) == 1 and all(math.isfinite(v) for k, v in val[0].items() if k.startswith("Val/"))
    else:
        assert not val
    moved = {n for n, p in tr.model.net.named_parameters() if not torch.equal(p, tr.initial[n])}
    coarse = {n for n in tr.initial if n.startswith(("coarse_branch.", "student.coarse_branch."))}
    trained = set(tr.initial) - coarse
    assert len(moved & trained) > 0.9 * len(trained)
    frozen = path.endswith("pr_u4k.py") or not e2e
    if frozen:
        assert coarse and not moved & coarse
    elif coarse and not path.endswith("semi_kitti.py"):
        assert moved >= coarse  # lr_mult 0.1 through DINOv2 and the DPT head
    report = tr.pretrained_report
    if path.endswith("pr_u4k.py"):
        stage1 = load_checkpoint(handoff["stage1"])["state_dict"]
        assert report["pretrain_coarse_model"]["taken"] == report["pretrain_fine_model"]["taken"] \
            == len(stage1)
        own = tr.model.net.state_dict()
        for k, v in stage1.items():  # the frozen coarse branch is the stage-1 network still
            assert torch.equal(own[k], v), k
    elif "pretrained" in model.get("config", {}):
        assert report["pretrained"]["taken"] > 0 and report["pretrained"]["kept"] > 0


@pytest.mark.parametrize("test_type", ["normal", "general"])
def test_da2_config_evaluates_through_the_test_cli(test_type, tmp_path, kitti, monkeypatch):  # noqa: F811
    """``python -m patchrefinerv2_torch.test`` (its ``main``, ``--device
    cpu``) on a DA2 config at tiny geometry: ``normal`` on
    ``plus_eff_kitti_base_coarse_e2e_c2f_pretrain.py``'s val loader over
    the two KITTI frames (finite metrics), ``general --save`` on
    ``plus_eff_u4k.py`` over a folder of two images (both PNGs written for
    each). Each frame's ``image_lr`` is 54x86, which the Depth-Anything
    resizer rounds to the 56x84 patches (K2 bilinear with align corners)."""
    import cv2

    calls = []
    resize = prp.resize

    def spy(x, size, *a, **k):
        calls.append((tuple(x.shape), tuple(size)))
        return resize(x, size, *a, **k)

    monkeypatch.setattr(prp, "resize", spy)
    lr = dict(transform_cfg=dict(network_process_size=[54, 86]))
    if test_type == "normal":
        path = DAV2 + "plus_eff_kitti_base_coarse_e2e_c2f_pretrain.py"
        over = dict(model=tiny_model(path, {}), test_in_dataloader=None, val_dataloader=dict(
            dataset=dict(lr, data_root=kitti["data_root"], split=kitti["split"])))
        args = []
    else:
        path = DAV2 + "plus_eff_u4k.py"
        rng = np.random.RandomState(3)
        for name in ("a.png", "b.png"):
            cv2.imwrite(str(tmp_path / name), rng.randint(0, 256, (112, 168, 3), np.uint8))
        over = dict(model=dict(config=dict(U4K, coarse_branch=TINY_DA2)), general_dataloader=dict(
            num_workers=1, dataset=dict(rgb_image_dir=str(tmp_path), image_raw_shape=[112, 168],
                                        network_process_size=[54, 86])))
        args = ["--test-type", "general", "--save", "--work-dir", str(tmp_path / "out")]
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(f"_base_ = [{str(ROOT / path)!r}]\n"
                        + "".join(f"{k} = {v!r}\n" for k, v in over.items()))
    out = evaluate.main([str(cfg_path), "--device", "cpu", "--cai-mode", "m1", *args])
    assert calls.count(((1, 54, 86, 3), (56, 84))) == 2  # one a frame
    if test_type == "normal":
        assert out and all(math.isfinite(v) for v in out.values())
    else:
        assert out == {}
        assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
            "a.png", "a_uint16.png", "b.png", "b_uint16.png"]
