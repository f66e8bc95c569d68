"""Synthetic in-memory frames, the port of
``patchrefinerv2_tpu/datasets/synthetic.py`` (``SyntheticDataset`` :13): a
random image and a random depth per index, made with numpy from ``seed +
index`` with the JAX dataset's draws. ``mode="infer"`` (the port's default)
gives the image, its low-resolution copy and the depth; ``mode="train"`` the
low-resolution image, one random crop (its resized image, depth and bbox in
the process frame) and the full depth, or with ``consistency`` the 16 fixed
overlapping crops (u4k_dataset.py:158-184). The resizes are K2's plain
version (bilinear, align_corners) in float32."""

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
    def __init__(self, mode: str = "infer", length: int = 8, image_raw_shape=(2160, 3840),
                 network_process_size=(384, 512), patch_raw_shape=(540, 960),
                 min_depth: float = 1e-3, max_depth: float = 80, seed: int = 0,
                 consistency: bool = False, overlap: int | None = None, **kwargs):
        if mode not in ("train", "infer"):
            raise ValueError(f"mode must be 'train' or 'infer', got {mode!r}")
        self.mode = mode
        self.length = length
        self.image_raw_shape = tuple(image_raw_shape)
        self.network_process_size = tuple(network_process_size)
        self.patch_raw_shape = tuple(patch_raw_shape)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.seed = seed
        self.consistency = consistency
        if consistency:
            h, w = self.image_raw_shape
            ov = int(overlap if overlap is not None else self.patch_raw_shape[0] // 2)
            self.h_start_list = [int(3 * ov / 2), int(h // 4 + ov / 2), int(2 * h // 4 - ov / 2),
                                 int(3 * h // 4 - 3 * ov / 2)]
            self.w_start_list = [int(3 * ov / 2), int(w // 4 + ov / 2), int(2 * w // 4 - ov / 2),
                                 int(3 * w // 4 - 3 * ov / 2)]

    def __len__(self) -> int:
        return self.length

    def _crop(self, image, depth, hs, ws):
        (h, w), (ph, pw), (nh, nw) = self.image_raw_shape, self.patch_raw_shape, self.network_process_size
        bbox = np.asarray([ws / w * nw, hs / h * nh, (ws + pw) / w * nw, (hs + ph) / h * nh], np.float32)
        return (resize_hwc(image[hs:hs + ph, ws:ws + pw], (nh, nw)),
                depth[hs:hs + ph, ws:ws + pw, None], bbox)

    def __getitem__(self, idx) -> dict:
        rng = np.random.RandomState(self.seed + idx)
        h, w = self.image_raw_shape
        ph, pw = self.patch_raw_shape
        image = rng.rand(h, w, 3).astype(np.float32)
        depth = (1.0 + 20.0 * rng.rand(h, w)).astype(np.float32)
        image_lr = resize_hwc(image, self.network_process_size)
        name = f"synthetic_{idx:04d}"
        if self.mode == "infer":
            return {"image_lr": image_lr, "image_hr": image, "depth_gt": depth[..., None],
                    "img_file_basename": name}
        if self.consistency:
            crops = [self._crop(image, depth, hs, ws)
                     for hs in self.h_start_list for ws in self.w_start_list]
            crop, crop_depth, bbox = (np.stack(c).astype(np.float32) for c in zip(*crops))
        else:
            hs, ws = rng.randint(0, h - ph + 1), rng.randint(0, w - pw + 1)
            crop, crop_depth, bbox = self._crop(image, depth, hs, ws)
        return {"image_lr": image_lr, "crops_image_hr": crop, "depth_gt": depth[..., None],
                "crop_depths": crop_depth, "bboxs": bbox, "img_file_basename": name}
