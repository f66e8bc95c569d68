"""The Cityscapes metric surface, the port of
``patchrefinerv2_tpu/datasets/cityscapes.py`` (``CityScapesDataset``:
``dataset_name``, the depth range and ``get_metrics`` :219-257). The file
reader (:118-217: PIL, cv2 and the camera json) is not ported; a subclass
that yields frames supplies ``__len__`` and ``__getitem__``."""

from __future__ import annotations

import torch

from patchrefinerv2_torch.datasets.base import DepthDataset
from patchrefinerv2_torch.evaluation.metrics import (
    compute_boundary_metrics, compute_metrics, extract_edges,
)
from patchrefinerv2_torch.ops.resize import resize


class CityScapesDataset(DepthDataset):
    def __init__(self, min_depth: float = 1e-3, max_depth: float = 250):
        self.dataset_name = "cityscapes"
        self.min_depth = min_depth
        self.max_depth = max_depth

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
