"""A folder of images, the port of ``patchrefinerv2_tpu/datasets/general.py``
(``read_general_image`` :32-61, ``read_general_depth`` :64-114,
``ImageDataset`` :117-165): what ``python -m patchrefinerv2_torch.test
--test-type general`` and ``--test-type gen`` read.

``read_general_image`` by ``dataset_name`` (and the file's extension):

- ``u4k``, or any ``.raw`` file: a 2160x3840x3 uint8 BGR blob;
- ``cityscapes``: the file as it is;
- ``kitti``: the KB crop to 352x1216;
- any other: resized to ``image_resolution`` when it is not that size
  (bicubic, align_corners on, clipped to [0, 1]).

Each gives float32 RGB / 255 (the files read by cv2). With ``gt_dir`` each
sample also has its depth and the boundary of its depth or disparity, by
``read_general_depth``: ``u4k`` a disparity ``.npy`` and its factor file
(``val_gt`` -> ``val_factor``, ``.txt``), ``gta`` a PNG / 256, ``eth3d`` a
4032x6048 float32 blob, ``mid`` a PFM disparity and its Middlebury
calibration file (``gts`` -> ``calibs``, ``.txt``; infinite disparity is
invalid), ``cityscapes`` an encoded disparity PNG (256 d + 1); any other
name raises. The image and gt file lists are the folders' sorted file names
with the extensions of ``IMG_EXTS`` and ``GT_EXTS``, paired in that order.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.datasets.eth3d import read_raw_depth
from patchrefinerv2_torch.datasets.kitti import kb_crop
from patchrefinerv2_torch.datasets.transforms import resize_hwc
from patchrefinerv2_torch.datasets.u4k import RAW_SHAPE
from patchrefinerv2_torch.datasets.utils import read_pfm
from patchrefinerv2_torch.evaluation.metrics import get_boundaries

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".raw")
GT_EXTS = IMG_EXTS + (".npy", ".pfm", ".exr")
ETH3D_SHAPE = (4032, 6048)


def _rgb(path: str) -> np.ndarray:
    import cv2

    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _edges(x: np.ndarray) -> np.ndarray:
    return get_boundaries(torch.from_numpy(x), th=1, dilation=0).numpy()


def read_general_image(path: str, dataset_name: str, image_resolution=RAW_SHAPE) -> np.ndarray:
    """The image of ``path`` as float32 (H, W, 3) RGB in [0, 1]."""
    if dataset_name == "u4k" or path.endswith(".raw"):
        img = np.fromfile(path, dtype=np.uint8).reshape(*RAW_SHAPE, 3)
        img = img[:, :, ::-1].astype(np.float32) / 255.0
    elif dataset_name == "cityscapes":
        img = _rgb(path).astype(np.float32) / 255.0
    elif dataset_name == "kitti":
        img = kb_crop(_rgb(path)).astype(np.float32) / 255.0
    else:
        img = _rgb(path).astype(np.float32) / 255.0
        if img.shape[:2] != tuple(image_resolution):
            img = resize_hwc(img, tuple(image_resolution), mode="bicubic", align_corners=True)
            img = np.clip(img, 0.0, 1.0)  # the bicubic lobes overshoot
    return np.ascontiguousarray(img, dtype=np.float32)


def read_general_depth(gt_path: str, dataset_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(depth, boundary), both float32 (H, W)."""
    import cv2

    if dataset_name == "u4k":
        with open(gt_path.replace("val_gt", "val_factor").replace(".npy", ".txt")) as f:
            factor = float(f.readline())
        disp = np.load(gt_path).astype(np.float32)
        edges = _edges(disp)
        with np.errstate(divide="ignore"):
            depth = factor / disp
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
    elif dataset_name == "gta":
        depth = np.asarray(cv2.imread(gt_path, cv2.IMREAD_UNCHANGED), np.float32) / 256.0
        edges = _edges(depth)
    elif dataset_name == "eth3d":
        depth = read_raw_depth(gt_path, ETH3D_SHAPE)
        edges = _edges(depth)
    elif dataset_name == "mid":
        # Middlebury calibration: cam0=[f ...], doffs=..., baseline=...
        with open(gt_path.replace("gts", "calibs").replace(".pfm", ".txt")) as f:
            lines = f.readlines()
        focal = float(lines[0].strip().split(" ")[0].split("[")[1])
        doffs = float(lines[2].strip().split("=")[1])
        base = float(lines[3].strip().split("=")[1])
        disp = read_pfm(gt_path)[0].astype(np.float32)
        invalid = disp == np.inf
        depth = (base * focal) / (disp + doffs) / 1000.0
        depth[invalid] = 0.0
        disp[invalid] = 0.0
        edges = _edges(disp)
    elif dataset_name == "cityscapes":
        disp = cv2.imread(gt_path, cv2.IMREAD_UNCHANGED).astype(np.float32)
        disp[disp > 0] = (disp[disp > 0] - 1) / 256.0
        with np.errstate(divide="ignore"):
            depth = (0.209313 * 2262.52) / disp
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
        edges = _edges(depth)
    else:
        raise NotImplementedError(f"no GT reader for dataset {dataset_name!r}")
    return depth.astype(np.float32), edges.astype(np.float32)


class ImageDataset(DepthDataset):
    def __init__(self, rgb_image_dir: str, dataset_name: str = "", gt_dir: str | None = None,
                 network_process_size=(384, 512), image_raw_shape=RAW_SHAPE, image_resolution=None,
                 min_depth: float = 1e-3, max_depth: float = 80, **kwargs):
        self.rgb_image_dir = rgb_image_dir
        self.dataset_name = dataset_name
        self.network_process_size = tuple(network_process_size)
        self.image_raw_shape = tuple(image_resolution or image_raw_shape)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.files = sorted(f for f in os.listdir(rgb_image_dir) if f.lower().endswith(IMG_EXTS))
        self.gt_dir = gt_dir
        if gt_dir is not None:  # gt and image files share their names: the sorted lists pair
            self.gt_files = sorted(f for f in os.listdir(gt_dir) if f.lower().endswith(GT_EXTS))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        path = osp.join(self.rgb_image_dir, self.files[idx])
        image = read_general_image(path, self.dataset_name, self.image_raw_shape)
        out = {"image_lr": resize_hwc(image, self.network_process_size), "image_hr": image,
               "img_file_basename": osp.splitext(osp.basename(path))[0]}
        if self.gt_dir is not None:
            depth, edges = read_general_depth(osp.join(self.gt_dir, self.gt_files[idx]),
                                              self.dataset_name)
            out["depth_gt"] = depth[..., None]
            out["boundary"] = edges[..., None]
        return out
