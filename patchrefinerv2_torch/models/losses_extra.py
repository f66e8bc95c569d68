"""The edge losses of PatchRefinerSemi, the port of
``patchrefinerv2_tpu/models/losses_extra.py`` (``_conv2d_same`` :58,
``kornia_sobel_magnitude`` :70, ``canny_edges_graph`` :92-134,
``EdgeguidedRankingLoss`` :137-270).

``canny_edges_graph`` is skimage's canny over (B, H, W) maps with the
reference's bounded hysteresis: a 9x9 Gaussian with constant padding and
bleed compensation, Sobel gradients with replicate padding (numpy's
``symmetric`` at width 1), ``jnp.hypot``'s formula, K11's non-maximum
suppression in float32 in its mask mode (the interior and nonzero-magnitude
masks and the two thresholds in the same launch), then K12 (``ops/canny.hysteresis_bounded``), which grows the
high mask for at most 128 steps. The Gaussian and Sobel cross-correlations
are ``F.conv2d`` in float32 with TF32 off (JAX's ``Precision.HIGHEST``).
Edges are no function of a gradient: they run under no gradient.

``EdgeguidedRankingLoss`` runs in two parts: :meth:`~EdgeguidedRankingLoss.sample`
draws the random samples on an explicit ``torch.Generator`` (per image: the
anchors over the edge mask, the distances, the direction draw and the
random pairs over the valid mask), and :meth:`~EdgeguidedRankingLoss.body`
is the deterministic loss of those samples, so that a caller can hand it
the JAX package's own samples, as rN takes the same crop starts on both
sides. The generators of JAX and PyTorch give other numbers from one seed.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.models.losses import _align_pred
from patchrefinerv2_torch.ops.canny import canny_nms_masks, hysteresis_bounded

__all__ = ["conv2d_same", "kornia_sobel_magnitude", "canny_edges_graph", "canny_masks",
           "EdgeguidedRankingLoss"]


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions at full precision (JAX's ``Precision.HIGHEST``)
    while the block runs, the setting restored after."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def conv2d_same(x: torch.Tensor, kern: torch.Tensor, mode: str) -> torch.Tensor:
    """Cross-correlate (B, H, W) maps with a 2-D kernel, the border padded by
    ``F.pad``'s ``mode`` (constant zeros, replicate or reflect)."""
    kh, kw = kern.shape
    xp = F.pad(x[:, None], (kw // 2, kw // 2, kh // 2, kh // 2), mode=mode)
    with _no_tf32():
        return F.conv2d(xp, kern[None, None].to(x.dtype))[:, 0]


def kornia_sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """``kornia.filters.sobel(x, normalized=True, eps=1e-6)`` of (B, H, W)
    maps, replicate padding. The reference samples its ranking directions
    with this magnitude as the angle, a quirk kept."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=x.device) / 8.0
    gx = conv2d_same(x, kx, "replicate")
    gy = conv2d_same(x, kx.T.contiguous(), "replicate")
    return torch.sqrt(gx * gx + gy * gy + 1e-6)


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula: max * sqrt(1 + (min / max)^2), 0 where both
    are 0, inf where either is."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    r = torch.where(zero, hi, hi * torch.sqrt(1 + torch.square(lo / torch.where(zero, 1.0, hi))))
    return torch.where(torch.isinf(a) | torch.isinf(b), math.inf, r)


def canny_edges_graph(x: torch.Tensor, sigma: float = 1.0, low_threshold: float = 0.1,
                      high_threshold: float = 0.2, hysteresis_iters: int = 128) -> torch.Tensor:
    """Canny edges (bool (B, H, W)) of float32 (B, H, W) maps, with the high
    mask grown ``hysteresis_iters`` steps inside the low one."""
    _, low_mask, high_mask = canny_masks(x, sigma, low_threshold, high_threshold)
    return hysteresis_bounded(low_mask, high_mask, hysteresis_iters)


def canny_masks(x: torch.Tensor, sigma: float = 1.0, low_threshold: float = 0.1,
                high_threshold: float = 0.2):
    """What :func:`canny_edges_graph` feeds its hysteresis: ((isobel, jsobel,
    magnitude), low mask, high mask) of float32 (B, H, W) maps."""
    with torch.no_grad():
        radius = max(1, int(4.0 * sigma + 0.5))
        t = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
        g1 = torch.exp(-0.5 * (t / sigma) ** 2)
        g1 = g1 / g1.sum()
        gauss2 = g1[:, None] * g1[None, :]
        bleed = conv2d_same(torch.ones_like(x), gauss2, "constant")
        smoothed = conv2d_same(x, gauss2, "constant") / (bleed + 1e-12)
        deriv = torch.tensor([-1.0, 0.0, 1.0], dtype=x.dtype, device=x.device)
        smooth = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
        jsobel = conv2d_same(smoothed, smooth[:, None] * deriv[None, :], "replicate")
        isobel = conv2d_same(smoothed, deriv[:, None] * smooth[None, :], "replicate")
        magnitude = _hypot(isobel, jsobel)
        low, high = canny_nms_masks(isobel, jsobel, magnitude, low_threshold, high_threshold)
        return (isobel, jsobel, magnitude), low, high


def _draw(mask: torch.Tensor, n: int, generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` flat indices a row drawn uniformly with replacement over the
    row's True pixels of ``mask`` (B, H, W), and whether the row has one. A
    row without one draws over all its pixels, to be masked by the caller,
    as JAX's ``categorical`` over all ``-1e30`` logits still draws."""
    flat = mask.reshape(mask.shape[0], -1)
    has = flat.any(1)
    weights = (flat | ~has[:, None]).float()
    return torch.multinomial(weights, n, replacement=True, generator=generator), has


class EdgeguidedRankingLoss:
    """The reference's edge-guided ranking loss of a prediction against a
    pseudo label: pairs of points straddling the pseudo label's canny edges,
    and as many random pairs over the valid mask, each scored by the ordinal
    relation of the two pseudo depths (equal within ``sigma``: squared
    difference; else a logistic ranking term). ``edge_quantile`` is taken
    and unused, as in the JAX package."""

    def __init__(self, point_pairs=10000, sigma=0.03, alpha=1.0, reweight_target=False,
                 only_missing_area=False, min_depth=1e-3, max_depth=80, missing_value=0,
                 random_direct=True, edge_quantile=0.95, **kw):
        self.point_pairs = point_pairs
        self.sigma = sigma
        self.alpha = alpha
        self.reweight_target = reweight_target
        self.only_missing_area = only_missing_area
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.missing_value = missing_value
        self.random_direct = random_direct
        self.edge_quantile = edge_quantile

    def maps(self, inputs, targets, depth_gt=None):
        """(pred, target, edges, theta, valid), each (B, H, W) at the
        prediction's size: the target and ``depth_gt`` (the target when
        None) resized to it, the canny edges of the log target within the
        anchor region (the valid gt, or its missing pixels), the target's
        Sobel magnitude as the angle, the valid-gt mask."""
        targets = _align_pred(targets, inputs)
        depth_gt = _align_pred(targets if depth_gt is None else depth_gt, inputs)
        pred, tgt, gt = inputs[..., 0], targets[..., 0], depth_gt[..., 0]
        with torch.no_grad():
            valid = (gt > self.min_depth) & (gt < self.max_depth)
            region = gt == self.missing_value if self.only_missing_area else valid
            log_t = torch.where(tgt > 0, torch.log(torch.clamp(tgt, min=1.19e-7)), 0.0)
            edges = canny_edges_graph(log_t.contiguous()) & region
            theta = kornia_sobel_magnitude(tgt.detach())
        return pred, tgt, edges, theta, valid

    def sample(self, edges: torch.Tensor, valid: torch.Tensor, generator=None) -> dict:
        """The random samples of a batch, drawn on ``generator`` (on the
        masks' device; None: a generator seeded 0), for :meth:`body`:
        ``anchor`` (B, n) flat indices over the edges, ``dist`` (B, 4, n)
        integers in [2, 31), ``swap`` (B,) the direction draw, ``ia`` and
        ``ib`` (B, 3n) flat indices over the valid mask, ``any_edge`` and
        ``any_valid`` (B,)."""
        if generator is None:
            generator = torch.Generator(device=edges.device).manual_seed(0)
        b, n = edges.shape[0], self.point_pairs
        anchor, any_edge = _draw(edges, n, generator)
        dist = torch.randint(2, 31, (b, 4, n), generator=generator, device=edges.device)
        swap = torch.rand((b,), generator=generator, device=edges.device) >= 0.5
        ia, any_valid = _draw(valid, 3 * n, generator)
        ib, _ = _draw(valid, 3 * n, generator)
        return dict(anchor=anchor, dist=dist, swap=swap, ia=ia, ib=ib, any_edge=any_edge,
                    any_valid=any_valid)

    def body(self, pred, tgt, theta, samples: dict):
        """(loss, sample count) of the samples: the means over the images of
        each image's loss and of its count of surviving pairs. The gradient
        reaches ``pred`` through its gathers only."""
        b, h, w = pred.shape
        anchor = samples["anchor"].long()
        ah, aw = anchor // w, anchor % w
        th = theta.reshape(b, -1).gather(1, anchor)[:, None]
        sign = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=pred.device)[None, :, None]
        dist = samples["dist"].float() * sign

        def offset(x):
            return torch.round(x).long()

        col = aw[:, None] + offset(dist * torch.cos(th))
        row = ah[:, None] + offset(dist * torch.sin(th))
        if self.random_direct:
            th2 = torch.remainder(th + math.pi / 2 + math.pi, 2 * math.pi) - math.pi
            swap = samples["swap"][:, None, None]
            col = torch.where(swap, aw[:, None] + offset(dist * torch.sin(th2)), col)
            row = torch.where(swap, ah[:, None] + offset(dist * torch.cos(th2)), row)
        inb = (col >= 0) & (col <= w - 1) & (row >= 0) & (row <= h - 1)
        pair_ok = inb.all(1) & samples["any_edge"][:, None]
        idx = (row.clamp(0, h - 1) * w + col.clamp(0, w - 1)).reshape(b, -1)
        p_flat, t_flat = pred.reshape(b, -1), tgt.reshape(b, -1)
        pa, ta = (f.gather(1, idx).reshape(b, 4, -1) for f in (p_flat, t_flat))
        ia, ib = samples["ia"].long(), samples["ib"].long()
        in_a = torch.cat([pa[:, 0], pa[:, 1], pa[:, 2], p_flat.gather(1, ia)], 1) / (250.0 / 80.0)
        in_b = torch.cat([pa[:, 1], pa[:, 2], pa[:, 3], p_flat.gather(1, ib)], 1) / (250.0 / 80.0)
        t_a = torch.cat([ta[:, 0], ta[:, 1], ta[:, 2], t_flat.gather(1, ia)], 1)
        t_b = torch.cat([ta[:, 1], ta[:, 2], ta[:, 3], t_flat.gather(1, ib)], 1)
        ok_r = pair_ok.repeat(1, 3) & samples["any_valid"][:, None]
        ok = torch.cat([pair_ok.repeat(1, 3), ok_r], 1).to(pred.dtype)

        ratio = (t_a + 1e-6) / (t_b + 1e-6)
        gap = torch.abs(t_a - t_b)
        weight = torch.exp(gap / (gap.amax(1, keepdim=True) + 1e-6))
        mask_eq = (ratio < 1.0 + self.sigma) & (ratio > 1.0 / (1.0 + self.sigma))
        labels = torch.where(ratio >= 1.0 + self.sigma, 1.0, 0.0)
        labels = torch.where(ratio <= 1.0 / (1.0 + self.sigma), -1.0, labels)
        diff = in_a - in_b
        if self.reweight_target:
            equal = diff ** 2 / weight * mask_eq
            unequal = torch.log1p(torch.exp(torch.clamp((-diff / weight) * labels, -30, 30))) * ~mask_eq
        else:
            equal = diff ** 2 * mask_eq
            unequal = torch.log1p(torch.exp(torch.clamp(-diff * labels, -30, 30))) * ~mask_eq
        count = ok.sum(1)
        denom = torch.clamp(count, min=1.0)
        li = self.alpha * (equal * ok).sum(1) / denom + (unequal * ok).sum(1) / denom
        return li.mean(), count.mean()

    def __call__(self, inputs, targets, images=None, depth_gt=None, generator=None, samples=None):
        """(loss, sample count) of ``inputs`` (B, H, W, 1) against
        ``targets``, with ``depth_gt`` as the valid mask's gt; the samples
        drawn on ``generator`` unless ``samples`` are given. ``images`` is
        taken and unused, as in the reference."""
        pred, tgt, edges, theta, valid = self.maps(inputs, targets, depth_gt)
        if samples is None:
            samples = self.sample(edges, valid, generator)
        return self.body(pred, tgt, theta, samples)


EXTRA_LOSSES = {"EdgeguidedRankingLoss": EdgeguidedRankingLoss}
