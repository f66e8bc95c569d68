"""Run metrics, the port of ``patchrefinerv2_tpu/utils/metrics_logger.py``:
one JSON line a record in ``work_dir/metrics.jsonl`` and image panels as
PNGs under ``work_dir/panels`` (``cv2``, imported only when a panel is
written). The JAX package also mirrors to wandb when it is importable; the
port writes only its files (the machines it runs on have no network)."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from patchrefinerv2_torch.utils.color import colorize


class MetricsLogger:
    def __init__(self, work_dir: str):
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self._f = open(os.path.join(work_dir, "metrics.jsonl"), "a")

    def log(self, scalars: dict, step: int) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_image(self, name: str, image, step: int) -> str | None:
        """An (H, W, 1 or 3) image in [0, 1] (or uint8) as a PNG; returns its path."""
        arr = np.asarray(image)
        if arr.ndim != 3 or arr.shape[-1] not in (1, 3):
            return None
        import cv2

        panel_dir = os.path.join(self.work_dir, "panels")
        os.makedirs(panel_dir, exist_ok=True)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if arr.shape[-1] == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
        path = os.path.join(panel_dir, f"{name}_{step:07d}.png")
        cv2.imwrite(path, arr)
        return path

    def log_images(self, log_dict: dict, prefix: str = "Train", scalar_cmap: str = "turbo_r",
                   min_depth: float = 1e-3, max_depth: float = 80, step: int = 0) -> str | None:
        """An rgb | depth_gt | depth_pred panel of the first batch element
        (reference trainer.py:55-125): the gt colorized with its invalid
        pixels masked, the prediction over its full range."""
        def first(x):
            a = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float32)
            return a[0] if a.ndim == 4 else a

        if "depth_pred" not in log_dict or "depth_gt" not in log_dict:
            return None
        depth_pred = first(log_dict["depth_pred"]).squeeze()
        depth_gt = first(log_dict["depth_gt"]).squeeze()
        invalid = np.logical_or(depth_gt <= min_depth, depth_gt >= max_depth)
        if invalid.all():
            return None
        gt_color = colorize(depth_gt, invalid_mask=invalid, cmap=scalar_cmap, vminp=0,
                            vmaxp=100)[..., :3]
        pred_color = colorize(depth_pred, vminp=0, vmaxp=100)[..., :3]
        tiles = [gt_color, pred_color]
        if log_dict.get("rgb") is not None:
            rgb = (np.clip(first(log_dict["rgb"]), 0, 1) * 255).astype(np.uint8)
            if rgb.shape[:2] != gt_color.shape[:2]:
                import cv2

                rgb = cv2.resize(rgb, (gt_color.shape[1], gt_color.shape[0]))
            tiles.insert(0, rgb)
        panel = np.concatenate(tiles, axis=1)
        return self.log_image(f"{prefix}_depth", panel.astype(np.float32) / 255.0, step)

    def close(self) -> None:
        self._f.close()
