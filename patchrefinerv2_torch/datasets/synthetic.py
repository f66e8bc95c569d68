"""Synthetic in-memory frames, the port of
``patchrefinerv2_tpu/datasets/synthetic.py`` (``SyntheticDataset`` :13) in
infer mode: a random image, its low-resolution copy and a random depth per
index, made with numpy from ``seed + index``."""

from __future__ import annotations

import numpy as np
import torch

from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.ops.resize import resize


def resize_hwc(image: np.ndarray, size, mode: str = "bilinear", align_corners: bool = True) -> np.ndarray:
    """Host resize of an (H, W, C) float32 array with ``F.interpolate``
    semantics (K2's plain version on the CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))[None]
    return resize(x, tuple(size), mode, align_corners)[0].numpy()


class SyntheticDataset(DepthDataset):
    def __init__(self, length: int = 8, image_raw_shape=(2160, 3840),
                 network_process_size=(384, 512), min_depth: float = 1e-3, max_depth: float = 80,
                 seed: int = 0):
        self.length = length
        self.image_raw_shape = tuple(image_raw_shape)
        self.network_process_size = tuple(network_process_size)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx) -> dict:
        rng = np.random.RandomState(self.seed + idx)
        h, w = self.image_raw_shape
        image = rng.rand(h, w, 3).astype(np.float32)
        depth = (1.0 + 20.0 * rng.rand(h, w)).astype(np.float32)
        return {
            "image_lr": resize_hwc(image, self.network_process_size),
            "image_hr": image,
            "depth_gt": depth[..., None],
            "img_file_basename": f"synthetic_{idx:04d}",
        }
