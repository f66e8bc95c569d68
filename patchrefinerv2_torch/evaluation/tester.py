"""Evaluation harness, the port of ``patchrefinerv2_tpu/evaluation/tester.py``
(``Tester.run`` :62-114, ``generate_pl`` :116-128): tiled inference of
every image of a loader, its metrics aggregated by the dataset, and the
depth image files. ``benchmark``, ``show_gts``, ``model_complexity``,
``vis_feat`` and ``run_consistency`` are not ported (ROADMAP.md, Queue 1
item 6)."""

from __future__ import annotations

import os

import numpy as np
import torch

from patchrefinerv2_torch.utils.color import save_colored, save_raw_16bit
from patchrefinerv2_torch.utils.logging import print_log


class Tester:
    """``save`` writes each image's depth into ``work_dir`` as
    ``{name}.png`` (colored) and ``{name}_uint16.png`` (depth x 256). The
    colormap: ``gray_r`` with ``gray_scale`` (between the 2nd and 95th
    percentiles), ``magma_r`` on Cityscapes, otherwise ``Spectral`` (both
    over the whole range)."""

    def __init__(self, config, model, dataloader, work_dir: str = "./work_dir", save: bool = False,
                 gray_scale: bool = False):
        self.config = config
        self.model = model
        self.dataloader = dataloader
        self.work_dir = work_dir
        self.save = save
        self.gray_scale = gray_scale
        name = getattr(getattr(dataloader, "dataset", None), "dataset_name", "")
        self.cmap = "gray_r" if gray_scale else "magma_r" if name == "cityscapes" else "Spectral"

    def _name(self, batch: dict, i: int) -> str:
        return batch.get("img_file_basename", [f"img_{i:05d}"])[0]

    def _save(self, depth: np.ndarray, name: str) -> None:
        os.makedirs(self.work_dir, exist_ok=True)
        percentiles = (2, 95) if self.gray_scale else (0, 100)
        save_colored(depth, os.path.join(self.work_dir, f"{name}.png"), self.cmap, *percentiles)
        save_raw_16bit(depth, os.path.join(self.work_dir, f"{name}_uint16.png"))

    def run(self, cai_mode="m1", process_num=4, image_raw_shape=(2160, 3840),
            patch_split_num=(4, 4)) -> dict:
        """Infer every image (one CPU generator per run draws the rN starts,
        image after image), save it with ``save``, and return the dataset's
        aggregate of the per-image metrics: ``{}`` without ground truth or
        without the dataset's ``get_metrics``, the nan-mean of each metric
        without its ``evaluate``."""
        results = []
        tile_cfg = {"image_raw_shape": list(image_raw_shape),
                    "patch_split_num": list(patch_split_num)}
        dataset = getattr(self.dataloader, "dataset", None)
        generator = torch.Generator().manual_seed(0)
        for i, batch in enumerate(self.dataloader):
            depth, _ = self.model.infer(batch["image_lr"], batch["image_hr"], cai_mode=cai_mode,
                                        process_num=process_num, tile_cfg=tile_cfg,
                                        generator=generator)
            if self.save:
                self._save(depth.cpu().numpy(), self._name(batch, i))
            if "depth_gt" in batch and hasattr(dataset, "get_metrics"):
                m = dataset.get_metrics(batch["depth_gt"], depth,
                                        disp_gt_edges=batch.get("boundary"),
                                        seg_image=batch.get("seg_image"))
                if m:
                    results.append(m)
        if not results:
            return {}
        if hasattr(dataset, "evaluate"):
            return dataset.evaluate(results)
        agg = {k: float(np.nanmean([r[k] for r in results])) for k in results[0]}
        print_log("metrics: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        return agg

    def generate_pl(self, cai_mode="m1", process_num=4) -> list:
        """Infer every image at the model's own tile geometry (one CPU
        generator per run, as ``run``) and write its depth as
        ``{name}_uint16.png`` (x 256) into ``work_dir``; returns the paths
        written."""
        os.makedirs(self.work_dir, exist_ok=True)
        generator = torch.Generator().manual_seed(0)
        written = []
        for i, batch in enumerate(self.dataloader):
            depth, _ = self.model.infer(batch["image_lr"], batch["image_hr"], cai_mode=cai_mode,
                                        process_num=process_num, generator=generator)
            written.append(os.path.join(self.work_dir, f"{self._name(batch, i)}_uint16.png"))
            save_raw_16bit(depth.cpu().numpy(), written[-1])
        print_log(f"pseudo labels written to {self.work_dir}")
        return written
