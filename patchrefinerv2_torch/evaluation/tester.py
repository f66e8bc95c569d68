"""Evaluation harness, the port of ``patchrefinerv2_tpu/evaluation/tester.py``
(``Tester.run`` :62-114): tiled inference of every image of a loader and
its metrics, aggregated by the dataset. The image dumps (``save``, which
needs ``utils/color.py``), ``generate_pl``, ``benchmark``,
``run_consistency`` and ``vis_feat`` are not ported."""

from __future__ import annotations

import torch


class Tester:
    def __init__(self, config, model, dataloader, save: bool = False):
        if save:
            raise NotImplementedError("saving depth images is not ported (utils/color.py)")
        self.config = config
        self.model = model
        self.dataloader = dataloader

    def run(self, cai_mode="m1", process_num=4, image_raw_shape=(2160, 3840),
            patch_split_num=(4, 4)) -> dict:
        """Infer every image (one CPU generator per run draws the rN starts,
        image after image) and return the dataset's aggregate of the
        per-image metrics (``{}`` without ground truth)."""
        results = []
        tile_cfg = {"image_raw_shape": list(image_raw_shape),
                    "patch_split_num": list(patch_split_num)}
        dataset = self.dataloader.dataset
        generator = torch.Generator().manual_seed(0)
        for batch in self.dataloader:
            depth, _ = self.model.infer(batch["image_lr"], batch["image_hr"], cai_mode=cai_mode,
                                        process_num=process_num, tile_cfg=tile_cfg,
                                        generator=generator)
            if "depth_gt" in batch:
                m = dataset.get_metrics(batch["depth_gt"], depth,
                                        disp_gt_edges=batch.get("boundary"),
                                        seg_image=batch.get("seg_image"))
                if m:
                    results.append(m)
        return dataset.evaluate(results) if results else {}
