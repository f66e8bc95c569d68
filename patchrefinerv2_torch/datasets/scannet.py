"""The ScanNet++ reader, the port of ``patchrefinerv2_tpu/datasets/scannet.py``
(``ScanNetDataset`` :24-165), and the frame-to-sample tail that the KITTI
and ETH3D readers inherit from it.

A split line names an image and its depth PNG under ``data_root`` (uint16,
depth times ``depth_scale``). An image of another size than
``image_raw_shape`` is resized to it (bilinear, align_corners on, back to
uint8), a depth of another size by F.interpolate's nearest rule. With
``with_pseudo_label`` the train sample also reads the offline pseudo label
``<pseudo_label_path>/<image path with "/" as "_", extension off>_uint16.png``
/ 256. Then ``_sample``: the rotation, colour and flip augmentations and one
random ``patch_raw_shape`` crop with its bbox in train mode; the image, its
resized copy, the depth and the depth's boundary in infer mode.
``get_metrics`` adds to the depth metrics their ``edge_`` and ``flat_``
copies over the gt boundary's pixels and the others.

Samples are dicts of HWC numpy arrays, equal to the JAX reader's when both
draw from the same seeded ``random`` and ``np.random`` states.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.datasets.transforms import (
    aug_color, aug_flip, aug_rotate, crop_bbox, random_crop, resize_hwc,
)
from patchrefinerv2_torch.datasets.utils import read_image
from patchrefinerv2_torch.evaluation.metrics import compute_metrics, get_boundaries


class ScanNetDataset(DepthDataset):
    dataset_name = "scannet"
    default_raw_shape = (1440, 1920)

    def __init__(self, mode, split, transform_cfg, min_depth=1e-3, max_depth=10,
                 data_root="./data/scannet", patch_raw_shape=(720, 960), depth_scale=1000.0,
                 with_pseudo_label=False, pseudo_label_path=None, pre_norm_bbox=True, **kwargs):
        self.mode = mode
        self.data_root = data_root
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.depth_scale = depth_scale
        self.transform_cfg = dict(transform_cfg or {})
        self.network_process_size = tuple(self.transform_cfg.get("network_process_size", [384, 512]))
        self.image_raw_shape = tuple(self.transform_cfg.get("image_raw_shape",
                                                            list(self.default_raw_shape)))
        self.patch_raw_shape = tuple(patch_raw_shape)
        self.with_pseudo_label = with_pseudo_label
        self.pseudo_label_path = pseudo_label_path
        self.pre_norm_bbox = pre_norm_bbox
        self.data_infos = self._load_split(split)

    @staticmethod
    def _skip(parts: list[str]) -> bool:
        return len(parts) < 2

    @staticmethod
    def _pseudo_name(img: str) -> str:
        return img.replace("/", "_").rsplit(".", 1)[0] + "_uint16.png"

    def _load_split(self, split: str) -> list[dict]:
        infos = []
        with open(split) as f:
            for line in f:
                parts = line.strip().split(" ")
                if self._skip(parts):
                    continue
                info = dict(filename=parts[0], img_path=osp.join(self.data_root, parts[0]),
                            depth_map_path=osp.join(self.data_root, parts[1]))
                if self.with_pseudo_label:
                    info["pseudo_label_path"] = osp.join(self.pseudo_label_path,
                                                         self._pseudo_name(parts[0]))
                infos.append(info)
        return sorted(infos, key=lambda x: x["img_path"])

    def __len__(self) -> int:
        return len(self.data_infos)

    def _raw_image(self, image: np.ndarray) -> np.ndarray:
        """A uint8 image at ``image_raw_shape`` (resized when it is not)."""
        if image.shape[:2] == self.image_raw_shape:
            return image
        return (resize_hwc(image.astype(np.float32) / 255.0, self.image_raw_shape) * 255
                ).astype(np.uint8)

    def _name(self, info: dict) -> str:
        return osp.splitext(osp.basename(info["filename"]))[0]

    def _frame(self, info: dict) -> tuple[np.ndarray, np.ndarray]:
        """The uint8 image and the float32 depth, both at ``image_raw_shape``."""
        image = self._raw_image(read_image(info["img_path"], mode="RGB"))
        depth_gt = read_image(info["depth_map_path"], np.float32) / self.depth_scale
        if depth_gt.shape != self.image_raw_shape:
            depth_gt = resize_hwc(depth_gt, self.image_raw_shape, "nearest", False)
        return image, depth_gt

    def __getitem__(self, idx: int) -> dict:
        info = self.data_infos[idx]
        image, depth_gt = self._frame(info)
        pseudo = None
        if self.mode == "train" and self.with_pseudo_label:
            pseudo = read_image(info["pseudo_label_path"], np.float32) / 256.0
        return self._sample(image, depth_gt, pseudo, self._name(info))

    def _sample(self, image: np.ndarray, depth_gt: np.ndarray, pseudo, name: str) -> dict:
        """The sample of a frame (the JAX readers' tail, ``kitti.py:100-146``):
        ``image`` uint8 (H, W, 3), ``depth_gt`` and ``pseudo`` (or None)
        float32 (H, W).

        Train: the rotation, the image / 255, the colour and flip
        augmentations, the image resized and one random crop with its bbox,
        the pseudo label cropped alike. Infer: the image, its resized copy,
        the depth and the depth's boundary."""
        train = self.mode == "train"
        if train:
            image, (depth_gt, pseudo) = aug_rotate(image, [depth_gt, pseudo],
                                                   self.transform_cfg.get("degree", 1.0))
        image = image.astype(np.float32) / 255.0
        if not train:
            return {"image_lr": resize_hwc(image, self.network_process_size), "image_hr": image,
                    "depth_gt": depth_gt[..., None],
                    "boundary": get_boundaries(torch.from_numpy(depth_gt), th=1, dilation=0).numpy(),
                    "img_file_basename": name}
        image = aug_color(image)
        image, (depth_gt, pseudo) = aug_flip(image, [depth_gt, pseudo])
        image_lr = resize_hwc(image, self.network_process_size)
        crop, (crop_depth, crop_pl), (hs, ws) = random_crop(image, [depth_gt, pseudo],
                                                            self.patch_raw_shape)
        out = {"image_lr": image_lr, "crops_image_hr": resize_hwc(crop, self.network_process_size),
               "depth_gt": depth_gt[..., None], "crop_depths": crop_depth[..., None],
               "bboxs": crop_bbox(ws, hs, self.patch_raw_shape, self.image_raw_shape,
                                  self.network_process_size, self.pre_norm_bbox),
               "img_file_basename": name}
        if crop_pl is not None:
            out["pseudo_label"] = crop_pl[..., None]
        return out

    def get_metrics(self, depth_gt, result, disp_gt_edges=None, **kwargs) -> dict:
        """The depth metrics (no crop), and with ``disp_gt_edges`` the same
        over the edge pixels (``edge_*``) and over the others (``flat_*``)."""
        kw = dict(min_depth_eval=self.min_depth, max_depth_eval=self.max_depth, garg_crop=False,
                  eigen_crop=False, dataset="")
        base = compute_metrics(depth_gt, result, disp_gt_edges=disp_gt_edges, **kw)
        if disp_gt_edges is not None and base:
            edges = torch.as_tensor(disp_gt_edges).squeeze().bool()
            for prefix, mask in (("edge_", edges), ("flat_", ~edges)):
                m = compute_metrics(depth_gt, result, additional_mask=mask, **kw)
                base.update({f"{prefix}{k}": v for k, v in m.items()})
        return base
