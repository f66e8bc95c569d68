"""Evaluation entry point, the port's counterpart of ``tools/test.py``:

    python -m patchrefinerv2_torch.test CONFIG [--ckp-path P] [--cai-mode m1|m2|rN]
                                        [--test-type normal|general|consistency|gen|benchmark]
                                        [--save] [--gray-scale] [--work-dir D]
                                        [--process-num N] [--image-raw-shape H W]
                                        [--patch-split-num h w] [--bench-iters N]
                                        [--bench-warmup N] [--bench-repeats N]
                                        [--cfg-option k=v ...] [--device cpu]

It builds the config's ``model`` (random weights from seed 0, as the JAX
tool's ``PRNGKey(0)``), merges the checkpoints the config names
(``pretrain_coarse_model``, ``pretrained``, ``whole_pretrained``, ...) and
then the ``--ckp-path`` checkpoint, one of the port's ``torch.save`` files
(``work_dir/checkpoint_NN`` of ``patchrefinerv2_torch.train``, or a bare
state dict), by key and shape; a tensor of it that the model cannot take
raises. A ``BaselinePretrain`` config (stage 1) evaluates its network: the
coarse target's low-resolution depth (resized to the ground truth by the
metrics), or the fine target's tiled depth in ``--cai-mode``.

- ``normal`` and ``benchmark`` read the config's ``test_in_dataloader``,
  ``consistency`` its ``val_consistency_dataloader``, ``general`` and
  ``gen`` its ``general_dataloader`` (an ``ImageDataset`` over a folder of
  images: ``--cfg-option general_dataloader.dataset.rgb_image_dir=D``);
  each falls back to the config's ``val_dataloader``. Any of the port's readers may stand there
  (UnrealStereo4K, Cityscapes, KITTI, ScanNet++, ETH3D, a folder of
  images, synthetic frames), loaded on the config's ``num_workers``
  threads.
- ``normal`` and ``general`` run ``Tester.run`` at the model's
  ``tile_cfg`` unless ``--image-raw-shape`` / ``--patch-split-num`` are
  given, and print the dataset's aggregate of the per-image metrics
  (``{}`` without ground truth). ``--save`` writes each image's colored
  depth ``{name}.png`` and ``{name}_uint16.png`` (depth x 256) into
  ``--work-dir`` (``--gray-scale``: the ``gray_r`` colormap).
- ``gen`` runs ``Tester.generate_pl`` at the model's own tile geometry:
  the pseudo labels ``{name}_uint16.png`` in ``--work-dir``.
- ``consistency`` runs ``Tester.run_consistency`` (a consistency-mode
  dataset: a fixed grid of overlapping crops, each through the model's
  training forward with BatchNorm on its running statistics) and prints
  the patch-overlap error; ``--save`` writes each image's mosaic.
- ``benchmark`` runs ``Tester.benchmark`` on the loader's first image
  (``image_hr`` defaults to ``image_lr``) in ``--cai-mode`` at the tile
  geometry above (``--bench-iters`` timed frames after ``--bench-warmup``,
  ``--bench-repeats`` times; ``benchmark.txt`` in ``--work-dir``), then
  ``Tester.model_complexity`` at its shapes, and prints ``{"benchmark":
  {"fps", "fps_variance"}, "complexity": {"flops", "params"}}``: ``params``
  the network's parameter elements (JAX's count of its ``params``),
  ``flops`` the port's own count of one frame's products (not XLA's).

``--cfg-option model.config.infer_dtype=bfloat16`` infers in bfloat16. It
runs on the card unless ``--device cpu`` is given, and raises when there is
none. Float32 matmuls and convolutions run without TF32.
"""

from __future__ import annotations

import argparse
import json
import random

import numpy as np
import torch

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.evaluation.tester import Tester
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.train import build_dataset
from patchrefinerv2_torch.utils.checkpoint import (
    apply_config_pretrained, load_checkpoint, merge_pretrained,
)
from patchrefinerv2_torch.utils.logging import print_log

TEST_TYPES = ("normal", "general", "consistency", "gen", "benchmark")
LOADERS = {"normal": "test_in_dataloader", "general": "general_dataloader",
           "consistency": "val_consistency_dataloader", "gen": "general_dataloader",
           "benchmark": "test_in_dataloader"}


def load_weights(model, path: str) -> int:
    """Merge a port checkpoint (a training state with ``state_dict``, or a
    state dict) into ``model.net`` by key and shape; returns the number of
    tensors taken. Raises when the checkpoint has a tensor the model lacks
    or holds in another shape: evaluating a model the checkpoint did not
    fill would report random weights."""
    ckpt = load_checkpoint(path)
    state = ckpt.get("state_dict", ckpt)
    merged, taken, skipped = merge_pretrained(model.net.state_dict(), state)
    if skipped:
        raise ValueError(f"{path}: {len(skipped)} of its {len(state)} tensors do not fit the "
                         f"model (key or shape), e.g. {skipped[:3]}")
    model.net.load_state_dict(merged)
    return len(taken)


def main(argv=None) -> dict:
    """Runs the test type; returns what it prints: ``{"metrics": ...}``'s
    metrics (``consistency``: the consistency error), for ``gen``
    ``{"pseudo_labels": [paths written]}``, for ``benchmark``
    ``{"benchmark": ..., "complexity": ...}``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--ckp-path", default=None)
    parser.add_argument("--cai-mode", default="m1")
    parser.add_argument("--process-num", type=int, default=4)
    parser.add_argument("--test-type", default="normal", choices=TEST_TYPES)
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--gray-scale", action="store_true")
    parser.add_argument("--work-dir", default="./work_dir/test")
    parser.add_argument("--image-raw-shape", nargs=2, type=int, default=None)
    parser.add_argument("--patch-split-num", nargs=2, type=int, default=None)
    parser.add_argument("--bench-iters", type=int, default=50)
    parser.add_argument("--bench-warmup", type=int, default=20)
    parser.add_argument("--bench-repeats", type=int, default=10)
    parser.add_argument("--cfg-option", nargs="+", default=None, help="dotted key=value overrides")
    parser.add_argument("--device", default=None, help="cpu runs the plain versions of the kernels")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_option)
    random.seed(621)
    np.random.seed(621)
    torch.manual_seed(621)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = build_model(cfg.model, device=args.device, seed=0)
    apply_config_pretrained(model)
    if args.ckp_path:
        taken = load_weights(model, args.ckp_path)
        print_log(f"loaded {args.ckp_path}: {taken} tensors")
    tc = model.tile_cfg
    raw = tuple(args.image_raw_shape or tc.image_raw_shape)
    split = tuple(args.patch_split_num or tc.patch_split_num)

    ds_cfg = cfg.get(LOADERS[args.test_type]) or cfg.get("val_dataloader")
    if not ds_cfg:
        raise ValueError(f"the config has neither {LOADERS[args.test_type]} nor val_dataloader")
    loader = DataLoader(build_dataset(ds_cfg.dataset), batch_size=1, shuffle=False,
                        num_workers=ds_cfg.get("num_workers", 1))
    tester = Tester(cfg, model, loader, work_dir=args.work_dir, save=args.save,
                    gray_scale=args.gray_scale)
    if args.test_type == "gen":
        print_log(f"generating pseudo labels of {len(loader.dataset)} images on {model.device}: "
                  f"{args.cai_mode}, process_num {args.process_num}")
        out = {"pseudo_labels": tester.generate_pl(cai_mode=args.cai_mode,
                                                   process_num=args.process_num)}
        print(json.dumps(out), flush=True)
        return out
    if args.test_type == "consistency":
        print_log(f"patch consistency of {len(loader.dataset)} images on {model.device}: "
                  f"process_num {args.process_num}")
        metrics = tester.run_consistency(process_num=args.process_num)
        print(json.dumps({"metrics": metrics}), flush=True)
        return metrics
    if args.test_type == "benchmark":
        first = iter(loader)
        batch = next(first)
        first.close()
        lr = torch.as_tensor(batch["image_lr"]).to(model.device)
        hr = torch.as_tensor(batch.get("image_hr", batch["image_lr"])).to(model.device)
        tile = {"image_raw_shape": list(raw), "patch_split_num": list(split)}
        print_log(f"benchmark on {model.device}: {args.cai_mode}, process_num {args.process_num}, "
                  f"raw {list(raw)}, split {list(split)}")
        out = {"benchmark": tester.benchmark(lr, hr, args.cai_mode, args.process_num,
                                             args.bench_iters, args.bench_warmup,
                                             args.bench_repeats, tile),
               "complexity": tester.model_complexity(tuple(lr.shape), tuple(hr.shape),
                                                     args.cai_mode, args.process_num, tile)}
        print(json.dumps(out), flush=True)
        return out
    print_log(f"testing {len(loader.dataset)} images on {model.device}: {args.cai_mode}, "
              f"process_num {args.process_num}, raw {list(raw)}, split {list(split)}")
    metrics = tester.run(cai_mode=args.cai_mode, process_num=args.process_num,
                         image_raw_shape=raw, patch_split_num=split)
    print(json.dumps({"metrics": metrics}), flush=True)
    return metrics


if __name__ == "__main__":
    main()
