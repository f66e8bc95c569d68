"""The ETH3D reader, the port of ``patchrefinerv2_tpu/datasets/eth3d.py``
(``ETHDataset`` :15-57): the ScanNet++ reader with 4032x6048 frames and
2016x3024 patches by default, whose depth is a float32 ``.raw`` or ``.bin``
blob at the image's size (NaN and infinities set to 0).

With such a depth the sample is the infer-mode one in every mode, train
included (the JAX reader's: it has no ``crops_image_hr``): the image
(resized to ``image_raw_shape`` when it is not), its resized copy, the depth
as read and its boundary. A PNG depth takes the ScanNet++ path."""

from __future__ import annotations

import numpy as np
import torch

from patchrefinerv2_torch.datasets.scannet import ScanNetDataset
from patchrefinerv2_torch.datasets.transforms import resize_hwc
from patchrefinerv2_torch.datasets.utils import read_image
from patchrefinerv2_torch.evaluation.metrics import get_boundaries


def read_raw_depth(path: str, shape) -> np.ndarray:
    """A float32 blob of ``shape``, NaN and infinities set to 0."""
    depth = np.fromfile(path, dtype=np.float32).reshape(*shape)
    return np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)


class ETHDataset(ScanNetDataset):
    dataset_name = "eth3d"
    default_raw_shape = (4032, 6048)

    def __init__(self, *args, patch_raw_shape=(2016, 3024), **kwargs):
        super().__init__(*args, patch_raw_shape=patch_raw_shape, **kwargs)

    def __getitem__(self, idx: int) -> dict:
        info = self.data_infos[idx]
        if not info["depth_map_path"].endswith((".raw", ".bin")):
            return super().__getitem__(idx)
        image = read_image(info["img_path"], mode="RGB")
        depth_gt = read_raw_depth(info["depth_map_path"], image.shape[:2])
        image = self._raw_image(image).astype(np.float32) / 255.0
        return {"image_lr": resize_hwc(image, self.network_process_size), "image_hr": image,
                "depth_gt": depth_gt[..., None],
                "boundary": get_boundaries(torch.from_numpy(depth_gt), th=1, dilation=0).numpy(),
                "img_file_basename": self._name(info)}
