"""The Cityscapes reader and its metric surface, the port of
``patchrefinerv2_tpu/datasets/cityscapes.py`` (``CityScapesDataset`` :40-257).

A split line names an image (``leftImg8bit/...png``) and its disparity PNG
(``disparity/...png``, uint16: 0 invalid, else 256 d + 1); the camera json
beside them (``camera/..._camera.json``) gives depth = baseline * fx / d.
The noisy border and the ego vehicle are marked -1 (the bottom quarter, the
left and right sixteenths). Then:

- ``mode="train"``: the ``skyArea`` PNG's pixels marked -2 (resized nearest
  to the depth when its size differs), with ``with_pseudo_label`` the
  offline pseudo label (``<pseudo_label_path>/<name>_uint16.png`` / 256) and
  with ``with_uncert`` its uncertainty (``_uncert_uint16.png`` / 256, set to
  1 where the ``_count_uint16.png`` count is below ``filter_thr`` times 171,
  log to ``base``, rescaled to [0, 1]); a PIL rotation (bilinear image,
  nearest maps), the image / 255, the colour and flip augmentations, the
  image resized to ``network_process_size`` and one random
  ``patch_raw_shape`` crop (image resized alike, depth, pseudo label and
  uncertainty) with its bbox;
- ``mode="infer"``: with ``with_seg_map`` the sky of the gtFine colour map
  (70, 130, 180) set to 0, then the image, its resized copy, the depth and
  the boundary of the filtered depth (the JAX reader's: not of the
  disparity). The sample carries no ``seg_image``, as the JAX reader's does
  not, so ``get_metrics`` gives no boundary F1 from the reader's frames.

Samples are dicts of HWC numpy arrays, equal to the JAX reader's when both
draw from the same seeded ``random`` and ``np.random`` states.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np
import torch

from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.datasets.transforms import (
    aug_color, aug_flip, aug_rotate, crop_bbox, random_crop, resize_hwc,
)
from patchrefinerv2_torch.datasets.utils import read_image
from patchrefinerv2_torch.evaluation.metrics import (
    compute_boundary_metrics, compute_metrics, extract_edges, get_boundaries,
)
from patchrefinerv2_torch.ops.resize import resize


def _nearest(x: np.ndarray, shape) -> np.ndarray:
    return resize_hwc(x, shape, "nearest", False) if x.shape != tuple(shape) else x


class CityScapesDataset(DepthDataset):
    def __init__(self, mode, split, transform_cfg, min_depth, max_depth, patch_raw_shape=(256, 512),
                 data_root="./data/cityscapes", resize_mode="zoe", with_pseudo_label=False,
                 pseudo_label_path=None, with_seg_map=False, filter_sky=True, pre_norm_bbox=True,
                 with_uncert=False, base=np.e, filter_thr=-0.1, **kwargs):
        self.dataset_name = "cityscapes"
        self.mode = mode
        self.data_root = data_root
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.transform_cfg = dict(transform_cfg or {})
        self.network_process_size = tuple(self.transform_cfg.get("network_process_size", [384, 512]))
        self.image_raw_shape = tuple(self.transform_cfg.get("image_raw_shape", [1024, 2048]))
        self.patch_raw_shape = tuple(patch_raw_shape)
        self.with_pseudo_label = with_pseudo_label
        self.pseudo_label_path = pseudo_label_path
        self.with_seg_map = with_seg_map
        self.with_uncert = with_uncert
        self.filter_sky = filter_sky
        self.pre_norm_bbox = pre_norm_bbox
        self.base = base
        self.filter_thr = filter_thr
        self.data_infos = self._load_split(split)

    def _load_split(self, split: str) -> list[dict]:
        infos = []
        with open(split) as f:
            for line in f:
                if not line.strip():
                    continue
                img, depth_map = line.strip().split(" ")
                info = dict(filename=img, img_path=osp.join(self.data_root, img),
                            depth_map_path=osp.join(self.data_root, depth_map))
                info["camera_info"] = (info["img_path"].replace("leftImg8bit", "camera")
                                       .replace(".png", ".json"))
                if self.filter_sky:
                    info["sky_seg_path"] = info["img_path"].replace("leftImg8bit", "skyArea")
                if self.with_pseudo_label:
                    pl = depth_map.replace("disparity", "leftImg8bit").replace("/", "_")
                    info["pseudo_label_path"] = osp.join(self.pseudo_label_path,
                                                         pl.replace(".png", "_uint16.png"))
                    if self.with_uncert:
                        for key, suffix in (("uncertain_path", "_uncert_uint16.png"),
                                            ("count_path", "_count_uint16.png")):
                            info[key] = info["pseudo_label_path"].replace("_uint16.png", suffix)
                if self.with_seg_map:
                    info["seg_map"] = (info["depth_map_path"].replace("disparity", "gtFine")
                                       .replace(".png", "_color.png"))
                infos.append(info)
        return sorted(infos, key=lambda x: x["img_path"])

    def __len__(self) -> int:
        return len(self.data_infos)

    def _pseudo(self, info: dict, shape):
        """The offline pseudo label and its rescaled uncertainty (or None)."""
        if self.mode != "train" or not self.with_pseudo_label:
            return None, None
        pseudo = _nearest(read_image(info["pseudo_label_path"], np.float32) / 256.0, shape)
        if not self.with_uncert:
            return pseudo, None
        un = read_image(info["uncertain_path"], np.float32) / 256.0
        count = read_image(info["count_path"], np.float32) / 256.0
        un[count < (16 + 9 + 9 + 9 + 128) * self.filter_thr] = 1.0
        un = np.log(1 + _nearest(un, shape)) / np.log(self.base)
        span = un.max() - un.min()
        return pseudo, (un - un.min()) / span if span > 0 else un * 0.0

    def __getitem__(self, idx: int) -> dict:
        info = self.data_infos[idx]
        image = read_image(info["img_path"], mode="RGB")
        with open(info["camera_info"]) as f:
            cam = json.load(f)
        disp = read_image(info["depth_map_path"]).astype(np.float32)
        disp[disp > 0] = (disp[disp > 0] - 1) / 256.0
        with np.errstate(divide="ignore", invalid="ignore"):
            depth_gt = (cam["extrinsic"]["baseline"] * cam["intrinsic"]["fx"]) / disp
        depth_gt = np.nan_to_num(depth_gt, posinf=0.0, neginf=0.0, nan=0.0).astype(np.float32)
        h, w = depth_gt.shape
        depth_gt[-h // 4:, :] = -1.0  # noisy border and ego vehicle (cityscapes_dataset.py:161-165)
        depth_gt[:, :w // 16] = -1.0
        depth_gt[:, -w // 16:] = -1.0
        train = self.mode == "train"

        if self.with_seg_map and not train:
            seg = read_image(info["seg_map"], mode="RGB")
            depth_gt[(seg[:, :, 0] == 70) & (seg[:, :, 1] == 130)] = 0.0
        if train and self.filter_sky and osp.exists(info.get("sky_seg_path", "")):
            depth_gt[_nearest(read_image(info["sky_seg_path"], np.float32), depth_gt.shape) > 0] = -2.0
        pseudo, uncert = self._pseudo(info, depth_gt.shape)

        if train:
            image, (depth_gt, pseudo, uncert) = aug_rotate(
                image, [depth_gt, pseudo, uncert], self.transform_cfg.get("degree", 1.0))
        image = image.astype(np.float32) / 255.0
        name = osp.splitext(info["filename"])[0].replace("/", "_")
        if not train:
            return {"image_lr": resize_hwc(image, self.network_process_size), "image_hr": image,
                    "depth_gt": depth_gt[..., None],
                    "boundary": get_boundaries(torch.from_numpy(depth_gt), th=1, dilation=0).numpy(),
                    "img_file_basename": name}

        image = aug_color(image)
        image, (depth_gt, pseudo, uncert) = aug_flip(image, [depth_gt, pseudo, uncert])
        image_lr = resize_hwc(image, self.network_process_size)
        crop, (crop_depth, crop_pl, crop_un), (hs, ws) = random_crop(
            image, [depth_gt, pseudo, uncert], self.patch_raw_shape)
        out = {"image_lr": image_lr, "crops_image_hr": resize_hwc(crop, self.network_process_size),
               "depth_gt": depth_gt[..., None], "crop_depths": crop_depth[..., None],
               "bboxs": crop_bbox(ws, hs, self.patch_raw_shape, self.image_raw_shape,
                                  self.network_process_size, self.pre_norm_bbox),
               "img_file_basename": name}
        if crop_pl is not None:
            out["pseudo_label"] = crop_pl[..., None]
        if crop_un is not None:
            out["pseudo_uncert"] = crop_un[..., None]
        return out

    def get_metrics(self, depth_gt, result, disp_gt_edges=None, seg_image=None, **kwargs) -> dict:
        """The depth metrics without crops, and with a gtFine label or color
        map ``seg_image``, the boundary metrics of the canny edges of the
        log prediction (resized to the gt shape, bilinear, align_corners on)
        against the label edges."""
        base = compute_metrics(
            depth_gt, result, disp_gt_edges=disp_gt_edges, min_depth_eval=self.min_depth,
            max_depth_eval=self.max_depth, garg_crop=False, eigen_crop=False,
            dataset=self.dataset_name)
        if seg_image is None or not base:
            return base
        pred = torch.as_tensor(result)
        dev = pred.device
        seg = torch.as_tensor(seg_image).to(dev).squeeze()
        if seg.ndim == 3:
            lab = seg[..., 0].long() * 65536 + seg[..., 1].long() * 256 + seg[..., 2].long()
        else:
            lab = seg.long()
        gt_edges = torch.zeros(lab.shape, dtype=torch.bool, device=dev)
        gt_edges[1:, :] |= lab[1:, :] != lab[:-1, :]
        gt_edges[:, 1:] |= lab[:, 1:] != lab[:, :-1]
        gt = torch.as_tensor(depth_gt).to(dev, torch.float64).squeeze()
        valid = (gt > self.min_depth) & (gt < self.max_depth)
        pred = pred.squeeze()
        if pred.shape != gt.shape:
            pred = resize(pred.float()[None, :, :, None].contiguous(), tuple(gt.shape), "bilinear",
                          align_corners=True)[0, :, :, 0]
        else:
            pred = pred.to(torch.float64)
        pred_edges = extract_edges(pred, preprocess="log")
        base.update(compute_boundary_metrics(gt, pred, gt_edges, valid, pred_edges))
        return base
