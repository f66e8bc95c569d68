"""Depth and boundary metrics, the port of
``patchrefinerv2_tpu/evaluation/metrics.py`` (``compute_errors`` :17,
``soft_edge_error`` :55, ``get_boundaries`` :64, ``_canny_numpy`` :82,
``extract_edges`` :120, ``compute_metrics`` :140, ``compute_boundary_metrics``
:210).

The maps are float64 tensors on the device of the prediction; each metric
is returned as a Python float. The pred -> gt bilinear resize is K2 in
float32 (the JAX package resizes in float64: expect ~1e-7 relative). Canny
runs on the device: masked gaussian smoothing and Sobel gradients written
in scipy's order of operations, K11 in its mask mode
(``ops/canny.canny_nms_masks``: the non-maximum suppression, the eroded
mask, the nonzero magnitude and both thresholds in one launch), and exact
hysteresis. The Euclidean distance
transforms of the boundary metrics run on the host through scipy, as in the
JAX package; the gaussian extends of the edge masks are 5x5 max pools on
the device. Nothing here needs cv2 or PIL.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops.canny import canny_nms_masks
from patchrefinerv2_torch.ops.resize import resize

__all__ = ["compute_errors", "compute_metrics", "soft_edge_error", "get_boundaries", "canny",
           "extract_edges", "compute_boundary_metrics"]

_ERROR_KEYS = ("a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel")


def _f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def compute_errors(gt: torch.Tensor, pred: torch.Tensor) -> dict:
    """a1/a2/a3, abs_rel, rmse, log_10, rmse_log, silog, sq_rel over the
    (flattened) valid pixels."""
    thresh = torch.maximum(gt / pred, pred / gt)
    err = torch.log(pred) - torch.log(gt)
    vals = torch.stack([
        (thresh < 1.25).double().mean(),
        (thresh < 1.25 ** 2).double().mean(),
        (thresh < 1.25 ** 3).double().mean(),
        torch.mean(torch.abs(gt - pred) / gt),
        torch.sqrt(((gt - pred) ** 2).mean()),
        torch.abs(torch.log10(gt) - torch.log10(pred)).mean(),
        torch.sqrt(((torch.log(gt) - torch.log(pred)) ** 2).mean()),
        torch.sqrt(torch.mean(err ** 2) - torch.mean(err) ** 2) * 100,
        torch.mean(((gt - pred) ** 2) / gt),
    ])
    return dict(zip(_ERROR_KEYS, vals.tolist()))


def _shift(data: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``shift_2d_replace``: ``data`` moved by dx columns and dy rows, zeros
    where nothing moved in."""
    h, w = data.shape
    padded = F.pad(data, (1, 1, 1, 1))
    return padded[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def soft_edge_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per pixel, the least |gt shifted by up to one pixel - pred| (the
    reference's radius 1, which every call site uses)."""
    out = None
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            d = torch.abs(_shift(gt, i, j) - pred)
            out = d if out is None else torch.minimum(out, d)
    return out


def compute_metrics(gt, pred, interpolate=True, garg_crop=False, eigen_crop=True, dataset="nyu",
                    min_depth_eval=0.1, max_depth_eval=10, disp_gt_edges=None,
                    additional_mask=None) -> dict:
    """Resize ``pred`` to the gt shape (bilinear, align_corners off), clamp it,
    mask the valid gt pixels (and the garg or eigen crop), and compute the
    errors there; with ``disp_gt_edges``, also SEE on the gt-edge pixels."""
    pred = torch.as_tensor(pred)
    dev = pred.device
    gt_depth = _f64(gt, dev).squeeze()
    pred = pred.squeeze()
    if gt_depth.shape != pred.shape and interpolate:
        pred = resize(pred.float()[None, :, :, None].contiguous(), tuple(gt_depth.shape),
                      "bilinear", align_corners=False)[0, :, :, 0]
    pred = pred.to(torch.float64)
    pred = torch.where(pred < min_depth_eval, min_depth_eval, pred)
    pred = torch.where(pred > max_depth_eval, max_depth_eval, pred)
    pred = torch.where(torch.isinf(pred), max_depth_eval, pred)
    pred = torch.where(torch.isnan(pred), min_depth_eval, pred)

    valid_mask = (gt_depth > min_depth_eval) & (gt_depth < max_depth_eval)
    gt_h, gt_w = gt_depth.shape
    if garg_crop or eigen_crop:
        eval_mask = torch.zeros_like(valid_mask)
        if garg_crop:
            eval_mask[int(0.40810811 * gt_h):int(0.99189189 * gt_h),
                      int(0.03594771 * gt_w):int(0.96405229 * gt_w)] = True
        elif dataset == "kitti":
            eval_mask[int(0.3324324 * gt_h):int(0.91351351 * gt_h),
                      int(0.0359477 * gt_w):int(0.96405229 * gt_w)] = True
        else:
            eval_mask[45:471, 41:601] = True
        valid_mask = valid_mask & eval_mask
    if additional_mask is not None:
        valid_mask = valid_mask & torch.as_tensor(additional_mask).to(dev).squeeze().bool()

    if not bool(valid_mask.any()):
        return {}
    metrics = compute_errors(gt_depth[valid_mask], pred[valid_mask])

    if disp_gt_edges is not None:
        edges = torch.as_tensor(disp_gt_edges).to(dev).squeeze().bool()
        mask = valid_mask & edges
        see = 0.0
        if bool(mask.any()):
            see = float(soft_edge_error(pred, gt_depth)[mask].mean())
        metrics["see"] = see
    return metrics


def get_boundaries(disp, th: float = 1.0, dilation: int = 10) -> torch.Tensor:
    """float32 mask of the pixels whose value differs by more than ``th``
    from a 4-neighbour. Only ``dilation=0`` is ported (every call site): the
    dilation is cv2's."""
    if dilation > 0:
        raise NotImplementedError("get_boundaries is ported for dilation=0 (every call site)")
    d = torch.as_tensor(disp)
    edges = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    ey = torch.abs(d[1:, :] - d[:-1, :]) > th
    ex = torch.abs(d[:, 1:] - d[:, :-1]) > th
    edges[1:, :] |= ey
    edges[:-1, :] |= ey
    edges[:, 1:] |= ex
    edges[:, :-1] |= ex
    return edges.float()


def _gaussian_weights(sigma, truncate: float = 4.0) -> list[float]:
    """scipy's ``_gaussian_kernel1d`` (order 0, radius int(truncate * sigma
    + 0.5)), float64."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum()).tolist()


def _along(x: torch.Tensor, axis: int, pad: int, mode: str):
    """(taps) -> the (H, W) slice of ``x`` padded by ``pad`` along ``axis``
    (zeros, or the edge value repeated), offset by the tap."""
    n = x.shape[axis]
    if mode == "constant":
        xp = F.pad(x, (0, 0, pad, pad) if axis == 0 else (pad, pad))
    else:
        first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
        xp = torch.cat([first] * pad + [x] + [last] * pad, dim=axis)
    return lambda o: xp.narrow(axis, pad + o, n)


def _gaussian_filter(x: torch.Tensor, sigma) -> torch.Tensor:
    """``ndi.gaussian_filter(x, sigma, mode="constant")`` in scipy's order of
    operations for a symmetric kernel: along H, then along W, each output
    ``x[i] * w0 + sum over j from the outermost tap in of (x[i-j] + x[i+j]) * wj``."""
    w = _gaussian_weights(sigma)
    r = len(w) // 2
    for axis in (0, 1):
        tap = _along(x, axis, r, "constant")
        out = tap(0) * w[r]
        for j in range(r, 0, -1):
            out = out + (tap(-j) + tap(j)) * w[r - j]
        x = out
    return x


def _sobel(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``ndi.sobel(x, axis)`` (mode "reflect", which at width 1 repeats the
    edge): the central difference along ``axis``, then [1, 2, 1] across it."""
    tap = _along(x, axis, 1, "edge")
    d = tap(1) - tap(-1)
    tap = _along(d, 1 - axis, 1, "edge")
    return tap(0) * 2 + (tap(-1) + tap(1))


def _hysteresis(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """The pixels of each 8-connected component of ``low`` that holds a pixel
    of ``high`` (``ndi.label`` and a per-label sum, exactly): grow ``high``
    inside ``low`` by one pixel a step until nothing changes."""
    lowf = low.float()[None, None]
    cur = (high & low).float()[None, None]
    while True:
        prev = cur
        for _ in range(16):
            cur = F.max_pool2d(cur, 3, stride=1, padding=1) * lowf
        if torch.equal(cur, prev):
            return cur[0, 0] > 0


def canny(image, sigma=1.0, low_threshold=0.1, high_threshold=0.2, mask=None) -> torch.Tensor:
    """skimage.feature.canny of a (H, W) map as ``_canny_numpy`` computes it,
    in float64: masked gaussian smoothing with the bleed compensation, Sobel
    gradients, K11's non-maximum suppression with the eroded mask and the
    absolute low/high thresholds in one launch, and hysteresis. Returns a bool mask."""
    image = torch.as_tensor(image).to(torch.float64)
    dev = image.device
    mask = (torch.ones(image.shape, dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask).to(dev).bool())
    bleed = _gaussian_filter(mask.double(), sigma)
    smoothed = _gaussian_filter(image * mask, sigma) / (bleed + 1e-12)
    eroded = 1 - F.max_pool2d(1 - F.pad(mask.double(), (1, 1, 1, 1))[None, None], 3, stride=1)
    eroded = eroded[0, 0] > 0

    jsobel = _sobel(smoothed, axis=1).contiguous()
    isobel = _sobel(smoothed, axis=0).contiguous()
    magnitude = torch.hypot(isobel, jsobel)

    low_mask, high_mask = canny_nms_masks(isobel, jsobel, magnitude, low_threshold, high_threshold,
                                          eroded)
    return _hysteresis(low_mask, high_mask)


def extract_edges(depth, preprocess=None, sigma=1, mask=None) -> torch.Tensor:
    """Canny edges over the log (``preprocess="log"``) or the normalised
    inverse (``"inv"``) of ``depth``, in the depth's own dtype up to canny."""
    depth = torch.as_tensor(depth).squeeze()
    if preprocess == "log":
        depth = torch.where(depth > 0, torch.log(torch.clamp(depth, min=1.19e-7)),
                            torch.zeros((), dtype=depth.dtype, device=depth.device))
    elif preprocess == "inv":
        disp = 1.0 / torch.clamp(depth, min=1.19e-7)
        disp = torch.where(depth == 0, torch.zeros((), dtype=disp.dtype, device=disp.device), disp)
        depth = disp / (disp.max() + 1.19e-7)
    return canny(depth, sigma=sigma, mask=mask)


def _gaussian_extend(edges: torch.Tensor) -> torch.Tensor:
    """The reference's 5x5 gaussian blur (sigma 5, reflect-101) of an edge
    mask, > 0: every weight is positive and the reflected border adds no
    pixel outside the 5x5 window, so it is exactly a 5x5 binary dilation."""
    return F.max_pool2d(edges.float()[None, None], 5, stride=1, padding=2)[0, 0] > 0


def compute_boundary_metrics(gt, pred, gt_edges, valid_mask, pred_edges, th_edges_acc=10,
                             th_edges_comp=10) -> dict:
    """EdgeAcc / EdgeComp from distance transforms (scipy, on the host) and
    precision / recall / F1 of the gaussian-extended edge masks. ``gt`` and
    ``pred`` are not read (the reference's signature)."""
    from scipy import ndimage

    pred_edges = torch.as_tensor(pred_edges).bool()
    dev = pred_edges.device
    gt_edges = torch.as_tensor(gt_edges).to(dev).bool()
    valid_mask = torch.as_tensor(valid_mask).to(dev).bool()

    def edt(e):
        return torch.from_numpy(ndimage.distance_transform_edt(~e.cpu().numpy())).to(dev)

    d_target, d_pred = edt(gt_edges), edt(pred_edges)
    gt_in = gt_edges & valid_mask
    pred_close = pred_edges & valid_mask & (d_target < th_edges_acc)
    close = bool(pred_close.any())
    metrics = {
        "EdgeAcc": float(d_target[pred_close].mean()) if close else float(th_edges_acc),
        "EdgeComp": float(d_pred[gt_in].mean()) if close else float(th_edges_comp),
    }
    gt_ext = _gaussian_extend(gt_edges)[valid_mask]
    pred_ext = _gaussian_extend(pred_edges)[valid_mask]
    tp = float((pred_ext & gt_ext).sum())
    fp = float((pred_ext & ~gt_ext).sum())
    fn = float((~pred_ext & gt_ext).sum())
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    metrics.update({"precision": precision, "recall": recall, "f1": f1})
    return metrics
