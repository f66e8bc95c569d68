"""Training losses, the port of ``patchrefinerv2_tpu/models/losses.py``
(``_align_pred`` :30, ``SILogLoss`` :50, ``GradMatchLoss`` :82), without
the ``additional_mask`` that no port caller passes.

Predictions and targets are NHWC (B, H, W, 1) float32 tensors, masks
boolean. A prediction of another size than the target is first resized to
it (bilinear, align_corners, K2, differentiable). As in the reference, the
"too few valid pixels" guards are selects on the mask count, and the
variance is the unbiased one (n - 1).
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops.resize import resize

__all__ = ["SILogLoss", "GradMatchLoss", "build_loss"]

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


LOSSES = {"SILogLoss": SILogLoss, "GradMatchLoss": GradMatchLoss}


def build_loss(cfg: dict):
    """A loss from its config dict (``type`` and its keyword arguments)."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in LOSSES:
        raise NotImplementedError(f"loss {kind!r} is not ported ({sorted(LOSSES)} are)")
    return LOSSES[kind](**cfg)
