"""Training losses, the port of ``patchrefinerv2_tpu/models/losses.py``
(``_align_pred`` :30, ``SILogLoss`` :50, ``GradMatchLoss`` :82,
``missing_area_sampling_mask`` :133, ``compute_scale_and_shift`` :164,
``ScaleAndShiftInvariantDALoss`` :180, ``ScaleAndShiftInvariantLoss`` :208),
without the ``additional_mask`` that no port caller passes.

Predictions and targets are NHWC (B, H, W, 1) float32 tensors, masks
boolean. A prediction of another size than the target is first resized to
it (bilinear, align_corners, K2, differentiable). As in the reference, the
"too few valid pixels" guards are selects on the mask count, and the
variance is the unbiased one (n - 1).
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops.resize import resize

__all__ = ["SILogLoss", "GradMatchLoss", "ScaleAndShiftInvariantDALoss", "ScaleAndShiftInvariantLoss",
           "compute_scale_and_shift", "missing_area_sampling_mask", "build_loss"]

_ALPHA = 1e-7


def _align_pred(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if pred.shape[1:3] != target.shape[1:3]:
        pred = resize(pred, target.shape[1:3], "bilinear", True)
    return pred


def _valid(target, min_depth, max_depth):
    return (target > min_depth) & (target < max_depth)


class SILogLoss:
    """Masked scale-invariant log loss: 10 sqrt(var(g) + beta mean(g)^2)
    over the valid pixels of the batch, g = log(max(pred, 0) + 1e-7) -
    log(target + 1e-7); 0 with fewer than two valid pixels."""

    name = "SILog"

    def __init__(self, beta: float = 0.15, **kwargs):
        self.beta = beta

    def __call__(self, pred, target, min_depth, max_depth):
        pred = _align_pred(pred, target)
        mask = _valid(target, min_depth, max_depth)
        n = mask.to(pred.dtype).sum()
        g = torch.log(torch.maximum(pred, pred.new_zeros(())) + _ALPHA) - torch.log(target + _ALPHA)
        g = torch.where(mask, g, 0.0)
        mean = g.sum() / torch.clamp(n, min=1.0)
        var = torch.where(mask, (g - mean) ** 2, 0.0).sum() / torch.clamp(n - 1.0, min=1.0)
        loss = 10.0 * torch.sqrt(torch.clamp(var + self.beta * mean ** 2, min=1e-12))
        return torch.where(n > 1, loss, 0.0)


class GradMatchLoss:
    """Stride-2 masked gradient-of-difference L1 along H. The reference
    receives (B, 1, H, W) tensors there, so its "vertical" term slices the
    size-1 channel axis and is empty: only the H-axis term counts, as in the
    JAX package (losses.py:87-104)."""

    name = "GMLoss"

    def __init__(self, **kwargs):
        pass

    def __call__(self, pred, target, min_depth, max_depth):
        pred = _align_pred(pred, target)
        m = _valid(target, min_depth, max_depth).to(pred.dtype)
        n = m.sum()
        d = (pred - target) * m
        v = torch.abs(d[:, :-2] - d[:, 2:]) * (m[:, :-2] * m[:, 2:])
        return torch.where(n > 1, v.sum() / torch.clamp(n, min=1.0), 0.0)


def _grad_match(d_diff, m):
    """The SSI family's stride-2 masked gradient term over (B, H, W) maps,
    both axes (``losses.py:94-100``): (sum of the H- and W-axis terms) / n."""
    n = m.sum()
    d = d_diff * m
    v = torch.abs(d[:, :-2] - d[:, 2:]) * (m[:, :-2] * m[:, 2:])
    h = torch.abs(d[:, :, :-2] - d[:, :, 2:]) * (m[:, :, :-2] * m[:, :, 2:])
    return (v.sum() + h.sum()) / torch.clamp(n, min=1.0)


def _mask2d(mask) -> torch.Tensor:
    return (mask[..., 0] if mask.ndim == 4 else mask).float()


def missing_area_sampling_mask(gt_depth, pseudo, min_depth, max_depth):
    """The ``only_missing_area`` sampling mask (float32 (B, H, W)): pixels of
    valid gt, inside the 7x7 Gaussian blur (sigma 5, reflect) of the gt's
    zeros, and inside the same blur of the canny edges of the log pseudo
    label. ``gt_depth`` (B, H, W[, 1]), ``pseudo`` (B, H, W)."""
    from patchrefinerv2_torch.models.losses_extra import canny_edges_graph, conv2d_same

    gt = gt_depth[..., 0] if gt_depth.ndim == 4 else gt_depth
    t7 = torch.arange(7, dtype=torch.float32, device=gt.device) - 3.0
    g1 = torch.exp(-0.5 * (t7 / 5.0) ** 2)
    g1 = g1 / g1.sum()
    blur_k = g1[:, None] * g1[None, :]
    missing_ext = conv2d_same((gt == 0.0).float(), blur_k, "reflect") > 0
    valid = (gt > min_depth) & (gt < max_depth)
    log_t = torch.where(pseudo > 0, torch.log(torch.clamp(pseudo, min=1.19e-7)), 0.0)
    edges = canny_edges_graph(log_t)
    edges_ext = conv2d_same(edges.float(), blur_k, "reflect") > 0
    return (valid & missing_ext & edges_ext).float()


def compute_scale_and_shift(prediction, target, mask):
    """Per-image closed-form least squares of ``scale * prediction + shift``
    against ``target`` over ``mask`` ((B, H, W) each); (0, 0) where the
    system is singular."""
    a_00 = (mask * prediction * prediction).sum((1, 2))
    a_01 = (mask * prediction).sum((1, 2))
    a_11 = mask.sum((1, 2))
    b_0 = (mask * prediction * target).sum((1, 2))
    b_1 = (mask * target).sum((1, 2))
    det = a_00 * a_11 - a_01 * a_01
    valid = det > 0
    safe_det = torch.where(valid, det, 1.0)
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det, 0.0)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det, 0.0)
    return x_0, x_1


class ScaleAndShiftInvariantDALoss:
    """Depth-Anything's SSI: both maps standardised by their masked mean and
    unbiased std (n - 1, floored at 1e-8), then the gradient match or the
    masked L1 of the difference; 0 with fewer than two valid pixels."""

    def __init__(self, grad_matching: bool = True, **kwargs):
        self.grad_matching = grad_matching

    def __call__(self, pred, target, gt_depth=None, mask=None, min_depth=None, max_depth=None, **kw):
        pred = _align_pred(pred, target)
        p, t, m = pred[..., 0], target[..., 0], _mask2d(mask)
        n = m.sum()
        nn = torch.clamp(n, min=1.0)
        mu_p, mu_t = (p * m).sum() / nn, (t * m).sum() / nn
        dof = torch.clamp(n - 1.0, min=1.0)
        sd_p = torch.sqrt(torch.where(m > 0, (p - mu_p) ** 2, 0.0).sum() / dof)
        sd_t = torch.sqrt(torch.where(m > 0, (t - mu_t) ** 2, 0.0).sum() / dof)
        sp = (p - mu_p) / torch.clamp(sd_p, min=1e-8)
        st = (t - mu_t) / torch.clamp(sd_t, min=1e-8)
        if self.grad_matching:
            loss = _grad_match(sp - st, m)
        else:
            loss = (torch.abs(sp - st) * m).sum() / nn
        return torch.where(n > 1, loss, 0.0)


class ScaleAndShiftInvariantLoss:
    """MiDaS's SSI: the prediction aligned to the pseudo label by
    :func:`compute_scale_and_shift` (``ssi``), then the gradient match or the
    masked L1 of the difference over the mask, or over
    :func:`missing_area_sampling_mask` (``only_missing_area``); ``inverse``
    aligns the stride-2 differences of each axis instead. 0 with fewer than
    two pixels in the mask."""

    def __init__(self, ssi=True, only_missing_area=False, grad_matching=False, inverse=False, **kw):
        self.ssi = ssi
        self.only_missing_area = only_missing_area
        self.grad_matching = grad_matching
        self.inverse = inverse

    def __call__(self, pred, pseudo_label, gt_depth=None, mask=None, min_depth=None, max_depth=None,
                 **kw):
        pred = _align_pred(pred, pseudo_label)
        p, t, m = pred[..., 0], pseudo_label[..., 0], _mask2d(mask)
        n = m.sum()
        if self.inverse:
            parts = []
            for sl_a, sl_b in (((slice(None), slice(None, -2)), (slice(None), slice(2, None))),
                               ((slice(None), slice(None), slice(None, -2)),
                                (slice(None), slice(None), slice(2, None)))):
                d_p, d_t, d_m = p[sl_a] - p[sl_b], t[sl_a] - t[sl_b], m[sl_a] * m[sl_b]
                s, sh = compute_scale_and_shift(d_p, d_t, d_m)
                parts.append((torch.abs(s[:, None, None] * d_p + sh[:, None, None] - d_t) * d_m).sum())
            loss = (parts[0] + parts[1]) / torch.clamp(n, min=1.0)
            return torch.where(n > 1, loss, 0.0)
        if self.ssi:
            scale, shift = compute_scale_and_shift(p, t, m)
            p = scale[:, None, None] * p + shift[:, None, None]
        if self.only_missing_area:
            m = missing_area_sampling_mask(gt_depth, t, min_depth, max_depth)
            n = m.sum()
        if self.grad_matching:
            loss = _grad_match(p - t, m)
        else:
            loss = (torch.abs(p - t) * m).sum() / torch.clamp(n, min=1.0)
        return torch.where(n > 1, loss, 0.0)


LOSSES = {"SILogLoss": SILogLoss, "GradMatchLoss": GradMatchLoss,
          "ScaleAndShiftInvariantDALoss": ScaleAndShiftInvariantDALoss,
          "ScaleAndShiftInvariantLoss": ScaleAndShiftInvariantLoss}


def build_loss(cfg: dict):
    """A loss from its config dict (``type`` and its keyword arguments)."""
    from patchrefinerv2_torch.models.losses_extra import EXTRA_LOSSES

    table = {**LOSSES, **EXTRA_LOSSES}
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in table:
        raise NotImplementedError(f"loss {kind!r} is not ported ({sorted(table)} are; ROADMAP.md, "
                                  "Queue 1)")
    return table[kind](**cfg)
