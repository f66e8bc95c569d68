"""Training entry point, the port's counterpart of ``tools/train.py``:

    python -m patchrefinerv2_torch.train CONFIG --work-dir D [--cfg-option k=v ...]
                                         [--device cpu] [--seed S] [--resume-from P]

It builds the config's ``model`` by its ``type``, ``PatchRefinerPlus``,
``PatchRefiner`` (V1), ``PatchRefinerSemi`` or ``BaselinePretrain``, with
random weights from the seed, then the checkpoints the config names in
``pretrain_coarse_model``, ``pretrain_fine_model``, ``pretrained``,
``whole_pretrained`` or ``teacher_pretrain``; the port trains stage 1
(``BaselinePretrain``: a ZoeDepth or DA2 network alone, e.g.
``configs/patchrefinerv2_zoedepth/coarse_pretrain_u4k.py``; its
``checkpoint_NN`` is what later stages name in ``pretrain_coarse_model``),
the refiner's pretraining stage (``configs/patchrefinerv2_zoedepth/pretrain_eff_m0s1.py``),
stage 3 (``configs/patchrefinerv2_zoedepth/v2_eff_u4k.py``), V1
(``configs/patchrefiner_zoedepth/pr_u4k.py``), the Depth-Anything-V2
recipe's stages (``configs/patchrefinerv2_dav2/pretrain_eff_m0s1.py``,
``plus_eff_u4k*.py``, ``semi_kitti.py``, ``configs/patchrefiner_dav2/pr_u4k.py``)
and the
Semi transfer with an online teacher
(``configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_semi_online_ranking_ft.py``;
the offline transfer, ``plus_eff_cs_semi_offline_ssigm_ft.py``, takes the
Cityscapes reader's ``pseudo_label``; the KITTI and ScanNet++ ones,
``configs/patchrefinerv2_zoedepth_kitti/semi_eff.py`` and its ScanNet
twin, those readers'). Then the config's train dataset
(``UnrealStereo4kDataset``, ``CityScapesDataset``, ``KittiDataset``,
``ScanNetDataset`` and ``ETHDataset`` read their files under
``data_root`` by their ``split``; ``SyntheticDataset`` makes frames:
``--cfg-option train_dataloader.dataset.type=SyntheticDataset``, whose
frames must have the model's ``image_raw_shape``: the Cityscapes configs
keep theirs under ``transform_cfg``, so add
``train_dataloader.dataset.image_raw_shape=[1024,2048]``), a shuffled
loader of its ``batch_size`` that loads ahead on the config's
``num_workers`` threads, and runs ``Trainer.run``. The validation dataset
is skipped when the port has no such reader or its files cannot be read.
It runs on the card unless ``--device cpu`` is given, and raises when
there is none. Float32 matmuls and convolutions run without TF32 (set
here, and printed).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.cityscapes import CityScapesDataset
from patchrefinerv2_torch.datasets.eth3d import ETHDataset
from patchrefinerv2_torch.datasets.general import ImageDataset
from patchrefinerv2_torch.datasets.kitti import KittiDataset
from patchrefinerv2_torch.datasets.scannet import ScanNetDataset
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.datasets.u4k import UnrealStereo4kDataset
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.training.trainer import Trainer
from patchrefinerv2_torch.utils.logging import print_log

DATASETS = {"SyntheticDataset": SyntheticDataset, "UnrealStereo4kDataset": UnrealStereo4kDataset,
            "CityScapesDataset": CityScapesDataset, "KittiDataset": KittiDataset,
            "ScanNetDataset": ScanNetDataset, "ETHDataset": ETHDataset, "ImageDataset": ImageDataset}


def build_dataset(cfg: dict):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in DATASETS:
        raise NotImplementedError(f"dataset {kind!r} is not ported ({sorted(DATASETS)} are)")
    return DATASETS[kind](**cfg)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--tag", default="")
    parser.add_argument("--seed", type=int, default=621)
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--device", default=None, help="cpu runs the plain versions of the kernels")
    parser.add_argument("--cfg-option", nargs="+", default=None, help="dotted key=value overrides")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_option)
    cfg["seed"] = args.seed
    if args.resume_from:
        cfg["resume_from"] = args.resume_from
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work_dir = args.work_dir or os.path.join(
        "./work_dir", os.path.splitext(os.path.basename(args.config))[0], args.tag)

    dataset = build_dataset(cfg.train_dataloader.dataset)
    model_cfg = cfg.model.get("model_cfg_student") or cfg.model
    raw = tuple((model_cfg.get("config") or model_cfg).get("image_raw_shape", (2160, 3840)))
    if isinstance(dataset, SyntheticDataset) and tuple(dataset.image_raw_shape) != raw:
        raise ValueError(f"the synthetic frames are {list(dataset.image_raw_shape)} but the model's "
                         f"image_raw_shape is {list(raw)}: add --cfg-option "
                         f"train_dataloader.dataset.image_raw_shape=[{raw[0]},{raw[1]}]")
    model = build_model(cfg.model, device=args.device, seed=args.seed)
    train_loader = DataLoader(dataset, batch_size=cfg.train_dataloader.get("batch_size", 4),
                              shuffle=True, seed=args.seed,
                              num_workers=cfg.train_dataloader.get("num_workers", 1))
    val_loader = None
    if cfg.get("val_dataloader"):
        try:
            val_loader = DataLoader(build_dataset(cfg.val_dataloader.dataset), batch_size=1)
        except (NotImplementedError, OSError) as e:
            print_log(f"val dataset unavailable ({e}); skipping validation")
    Trainer(cfg, model, train_loader, val_loader, work_dir=work_dir).run()


if __name__ == "__main__":
    main()
