"""The UnrealStereo4K reader, the port of ``patchrefinerv2_tpu/datasets/u4k.py``
(``UnrealStereo4kDataset`` :32-191).

A frame is a raw 2160x3840x3 uint8 BGR blob (``.../Image0/N.raw``), its
float32 disparity (``.../Disp0/N.npy``) and the stereo extrinsics
(``.../Extrinsics0/N.txt``, ``Extrinsics1``): depth = base * focal /
disparity, the focal the first value of Extrinsics0, the base the distance
between the two cameras' x translations (1 when the files are missing).

- ``mode="train"``: a PIL rotation (bilinear image, nearest depth), BGR
  to RGB / 255, the colour and flip augmentations, the image
  resized to ``network_process_size`` and one random ``patch_raw_shape``
  crop resized alike, with its bbox (in the process frame with
  ``pre_norm_bbox``, else in raw pixels); ``consistency=True`` takes the 16
  fixed overlapping crops of a 4x4 grid instead;
- ``mode="infer"``: the image by the host library (BGR to RGB times
  1/255.f), its resized copy, the depth and the disparity's boundary.

Samples are dicts of HWC numpy arrays, equal to the JAX reader's when both
draw from the same seeded ``random`` and ``np.random`` states.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from patchrefinerv2_torch.datasets import native
from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.datasets.transforms import (
    aug_color, aug_flip, aug_rotate, crop_bbox, random_crop, resize_hwc,
)
from patchrefinerv2_torch.evaluation.metrics import get_boundaries

RAW_SHAPE = (2160, 3840)  # every UnrealStereo4K frame


class UnrealStereo4kDataset(DepthDataset):
    def __init__(self, mode: str, data_root: str, split: str, min_depth: float = 1e-3,
                 max_depth: float = 80, transform_cfg: dict | None = None,
                 patch_raw_shape=(540, 960), pre_norm_bbox: bool = True, consistency: bool = False,
                 overlap: int = 270, **kwargs):
        self.mode = mode
        self.data_root = data_root
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.transform_cfg = dict(transform_cfg or {})
        self.network_process_size = tuple(self.transform_cfg.get("network_process_size", [384, 512]))
        self.image_raw_shape = tuple(self.transform_cfg.get("image_raw_shape", list(RAW_SHAPE)))
        self.degree = float(self.transform_cfg.get("degree", 1.0))
        self.patch_raw_shape = tuple(patch_raw_shape)
        self.pre_norm_bbox = pre_norm_bbox
        self.consistency = consistency
        self.overlap = overlap
        if consistency:  # the 4x4 overlapping grid (u4k_dataset.py:62-65)
            ov = overlap
            self.h_start_list = [int(3 * ov / 2), int(540 + ov / 2), int(1080 - ov / 2),
                                 int(1620 - 3 * ov / 2)]
            self.w_start_list = [int(3 * ov / 2), int(960 + ov / 2), int(1920 - ov / 2),
                                 int(2880 - 3 * ov / 2)]
        self.data_infos = self._load_split(split)

    def _load_split(self, split: str) -> list[dict]:
        infos = []
        with open(split) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                img_rel = line.split(" ")[0]
                disp_rel = img_rel.replace("Image0", "Disp0").rsplit(".", 1)[0] + ".npy"
                info = {"filename": img_rel, "img_path": osp.join(self.data_root, img_rel.lstrip("/")),
                        "depth_map_path": osp.join(self.data_root, disp_rel.lstrip("/"))}
                ext_l, ext_r = (info["depth_map_path"].replace("Disp0", name).replace(".npy", ".txt")
                                for name in ("Extrinsics0", "Extrinsics1"))
                info["depth_factor"] = 1.0
                if osp.exists(ext_l) and osp.exists(ext_r):
                    with open(ext_l) as fl, open(ext_r) as fr:
                        l_lines, r_lines = fl.readlines(), fr.readlines()
                    focal = float(l_lines[0].split(" ")[0])
                    base = abs(float(l_lines[1].split(" ")[3]) - float(r_lines[1].split(" ")[3]))
                    info["depth_factor"] = base * focal
                infos.append(info)
        return sorted(infos, key=lambda x: x["img_path"])

    def __len__(self) -> int:
        return len(self.data_infos)

    def _bbox(self, ws: int, hs: int) -> np.ndarray:
        return crop_bbox(ws, hs, self.patch_raw_shape, self.image_raw_shape,
                         self.network_process_size, self.pre_norm_bbox)

    def __getitem__(self, idx: int) -> dict:
        info = self.data_infos[idx]
        disp_gt = np.load(info["depth_map_path"], mmap_mode="c").astype(np.float32)
        depth_gt = info["depth_factor"] / disp_gt
        name = osp.splitext(info["filename"])[0].replace("/", "_").lstrip("_")

        if self.mode != "train":
            image = native.load_raw_bgr_as_rgb_f32(info["img_path"], *RAW_SHAPE)
            return {"image_lr": resize_hwc(image, self.network_process_size), "image_hr": image,
                    "depth_gt": depth_gt[..., None].astype(np.float32),
                    "boundary": get_boundaries(torch.from_numpy(disp_gt), th=1, dilation=0).numpy(),
                    "img_file_basename": name}

        image = np.fromfile(info["img_path"], dtype=np.uint8).reshape(*RAW_SHAPE, 3)
        # the disparity, which the JAX reader also rotates, flips and crops
        # here, is not used in training: the draws and samples are the same
        image, (depth_gt,) = aug_rotate(image, [depth_gt], self.degree)
        image = image.astype(np.float32)[:, :, ::-1] / 255.0  # BGR to RGB
        image = aug_color(image)
        image, (depth_gt,) = aug_flip(image, [depth_gt])
        out = {"image_lr": resize_hwc(image, self.network_process_size),
               "depth_gt": depth_gt[..., None].astype(np.float32)}
        ph, pw = self.patch_raw_shape
        if self.consistency:  # 16 fixed overlapping crops (u4k_dataset.py:158-184)
            starts = [(hs, ws) for hs in self.h_start_list for ws in self.w_start_list]
            out.update(
                crops_image_hr=np.stack([resize_hwc(image[hs:hs + ph, ws:ws + pw],
                                                    self.network_process_size)
                                         for hs, ws in starts]),
                crop_depths=np.stack([depth_gt[hs:hs + ph, ws:ws + pw, None] for hs, ws in starts]
                                     ).astype(np.float32),
                bboxs=np.stack([self._bbox(ws, hs) for hs, ws in starts]))
        else:
            crop, (crop_depth,), (hs, ws) = random_crop(image, [depth_gt], self.patch_raw_shape)
            out.update(crops_image_hr=resize_hwc(crop, self.network_process_size),
                       crop_depths=crop_depth[..., None].astype(np.float32), bboxs=self._bbox(ws, hs))
        out["img_file_basename"] = name
        return out
