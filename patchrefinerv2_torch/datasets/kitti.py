"""The KITTI reader, the port of ``patchrefinerv2_tpu/datasets/kitti.py``
(``KittiDataset`` :24-146): the ScanNet++ reader with KITTI's split, files
and metrics.

A split line names an image and its depth PNG under ``data_root`` (uint16,
depth times 256); a line whose depth is missing or ``None`` is skipped.
Both are cropped to 352x1216 (the KB crop: the bottom rows, centred), and
neither is resized. With ``with_pseudo_label`` the train sample also reads
the offline pseudo label ``<pseudo_label_path>/<image path with "/" as "_",
.png or .jpg as _uint16.png>`` / 256, at the size it was written. The
sample is the ScanNet++ reader's; the metrics take the Garg crop.
"""

from __future__ import annotations

import numpy as np

from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.datasets.scannet import ScanNetDataset
from patchrefinerv2_torch.datasets.utils import read_image

KB_CROP = (352, 1216)


def kb_crop(x: np.ndarray) -> np.ndarray:
    """The KB crop of an (H, W, ...) array: its last 352 rows, 1216 columns
    centred (left ``int((W - 1216) / 2)``)."""
    h, w = x.shape[:2]
    top, left = int(h - KB_CROP[0]), int((w - KB_CROP[1]) / 2)
    return x[top:top + KB_CROP[0], left:left + KB_CROP[1]]


class KittiDataset(ScanNetDataset):
    garg_crop = True
    eigen_crop = False
    dataset_name = "kitti"
    default_raw_shape = KB_CROP
    get_metrics = DepthDataset.get_metrics

    def __init__(self, mode, split, transform_cfg, min_depth=1e-3, max_depth=80,
                 data_root="./data/kitti", patch_raw_shape=(176, 304), do_kb_crop=True, **kwargs):
        self.do_kb_crop = do_kb_crop
        kwargs["depth_scale"] = 256.0
        super().__init__(mode, split, transform_cfg, min_depth=min_depth, max_depth=max_depth,
                         data_root=data_root, patch_raw_shape=patch_raw_shape, **kwargs)

    @staticmethod
    def _skip(parts: list[str]) -> bool:
        return parts[0] == "" or len(parts) < 2 or parts[1] == "None"

    @staticmethod
    def _pseudo_name(img: str) -> str:
        return img.replace("/", "_").replace(".png", "_uint16.png").replace(".jpg", "_uint16.png")

    def _frame(self, info: dict) -> tuple[np.ndarray, np.ndarray]:
        image = read_image(info["img_path"], mode="RGB")
        depth_gt = read_image(info["depth_map_path"], np.float32) / self.depth_scale
        if self.do_kb_crop:
            image, depth_gt = kb_crop(image), kb_crop(depth_gt)
        return image, depth_gt
