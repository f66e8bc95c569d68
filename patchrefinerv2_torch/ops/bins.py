"""K8: the ZoeDepth bins head's per-pixel math, with the bilinear resize of
the bin centres taken in: two CUDA kernels, ``csrc/bins.cu``.

Counterpart of ``patchrefinerv2_tpu/models/backbones/zoedepth.py``:

- :func:`attractor_update` -- the attractor shift of the bin centres,
  ``b_new = b_centers + reduce_na(dist(a - b_centers))`` (``exp_attractor``
  :39, ``inv_attractor`` :44, ``AttractorLayerUnnormed`` :117-132,
  ``AttractorLayerNormed`` :149-170), where ``b_centers`` is the previous
  layer's centres resized to the layer's size (``_interp(b_prev, ...)``,
  :124 and :159). The reference quirk is kept: ``dist`` runs with alpha 300
  and gamma 2 whatever the config says (:49-56). Normed layers also return
  the centres scaled to [min_depth, max_depth], sorted and clipped.
- :func:`log_binomial_depth` -- from the softplus ``pt`` of
  ``ConditionalLogBinomial`` (:195-217) to the depth: the binomial
  log-probabilities (``log_binom`` :173 with xlogy semantics), the softmax
  over the K bins with the temperature, and the expectation over the last
  centres resized to the output (``_interp(b_centers, ...)``, :375-376).

Layout: channels last, (B, H, W, na), (B, h, w, nb), (B, H, W, 4), (B, h,
w, K). The resize is K2's (bilinear, align_corners, the taps of
``ops/resize``), its result rounded to the input dtype; at equal sizes the
centres are used as they are. The attractor math runs in the input dtype, as
the JAX layers write it: each elementwise step is rounded to it, and the
reduction over the attractors accumulates in float32. The log-binomial math
runs in float32 and only the depth is rounded to the input dtype.

On a CUDA tensor the functions launch their kernel (or raise), which
gathers the resize taps itself, so the upsampled centres are never
written; :func:`launch_plan` and :func:`log_binomial_plan` shape the
launches. On a CPU tensor they run their plain versions, the resize and
then the math. ``attractor_update.launches`` and
``log_binomial_depth.launches`` count the launches.

Under autograd both functions are ``torch.autograd.Function``s whose
backwards are written in PyTorch ops (:func:`attractor_backward`,
:func:`log_binomial_backward`), for every form the forward takes (inv and
exp, mean and sum, unnormed and normed with its sort and clip): the
centres' resize is recomputed by K2 (its kernel on the card, one launch),
the gradient is taken at that size and then carried back to the previous
size by the transpose of K2's taps (``index_add_``). It is the transpose of
the resize the forward computed: ``aten.upsample_bilinear2d_backward``
(K2's ``_Resize``) takes its weights in the gradient's dtype, which in
float64 differ from K2's float32 taps by ~1e-7.

The log-binomial softmax divides logits of magnitude up to ~600 by a
temperature down to ``min_temp`` (0.0212 in the flagship), so a 1-ulp
difference in a logarithm or a quotient can move a probability by ~1e-4
relative: the kernel computes ``log``, ``exp`` and the correctly rounded
division as PyTorch's CUDA ops do, to stay within that of the plain
version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops._grad import require_float, wants_grad, wide
from patchrefinerv2_torch.ops.resize import (
    _alignment, _packed_taps_on, _taps_on, axis_taps, resize, resize_plain,
)

__all__ = ["attractor_backward", "attractor_update", "attractor_update_plain", "launch_plan",
           "log_binomial_backward", "log_binomial_depth", "log_binomial_depth_plain",
           "log_binomial_plan"]

ATTRACTOR_ALPHA = 300.0  # attractor.py's jit-script default, used whatever the config says
P_EPS = 1e-4
MAX_BINS = 1024
BLOCK_THREADS = 256  # the attractor kernel's largest block
THREADS_PER_SM = 256  # threads an SM the attractor kernel must keep with 16-byte bin vectors
LB_SMEM = 48 * 1024  # the log-binomial kernel's shared memory at most (bytes)


# ---------------------------------------------------------------- plain versions
def _resized(b, size):
    """``b`` (B, h, w, C) at ``size`` as K2 resizes it (bilinear,
    align_corners), or ``b`` itself at its own size."""
    if tuple(b.shape[1:3]) == tuple(size):
        return b
    return resize_plain(b, size, "bilinear", True)


def _dist(dx, attractor_type: str):
    if attractor_type == "inv":
        return dx / (1 + ATTRACTOR_ALPHA * dx ** 2)
    return torch.exp(-ATTRACTOR_ALPHA * torch.abs(dx) ** 2) * dx


def attractor_update_plain(a, b_prev, kind: str = "mean", attractor_type: str = "inv",
                           normed: bool = False, min_depth: float = 1e-3, max_depth: float = 10.0):
    """Plain PyTorch version of :func:`attractor_update` (any device), in
    the input dtype as the JAX layers compute it."""
    b_centers = _resized(b_prev, a.shape[1:3])
    dx = a[..., :, None] - b_centers[..., None, :]
    delta = _dist(dx, attractor_type)
    delta = delta.mean(-2) if kind == "mean" else delta.sum(-2)
    b_new = b_centers + delta
    if not normed:
        return b_new, b_new
    centers = (max_depth - min_depth) * b_new + min_depth
    return b_new, torch.sort(centers, dim=-1).values.clamp(min_depth, max_depth)


def log_binom(n, k, eps: float = 1e-7):
    """Stirling log(n choose k) (dist_layers.py:25-33) with xlogy semantics."""
    n = n + eps
    k = k + eps
    return torch.xlogy(n, n) - torch.xlogy(k, k) - torch.xlogy(n - k, n - k + eps)


@functools.lru_cache(maxsize=16)
def _log_binom_table(k: int, device) -> torch.Tensor:
    """log_binom(K - 1, k) for k = 0 .. K - 1, float32: a constant of K
    (made outside inference mode, as ``resize._taps_on`` is)."""
    with torch.inference_mode(False):
        idx = torch.arange(k, dtype=torch.float32)
        return log_binom(torch.tensor(k - 1, dtype=torch.float32), idx).to(device)


def _log_binomial_logits(pt, n_bins: int, min_temp: float, max_temp: float):
    """(p, t, one_minus_p, y): the binomial parameter, the temperature, the
    clipped 1 - p and the log-probabilities (B, H, W, K) of the softplus
    output ``pt``, in float32 (float64 for float64)."""
    pt = wide(pt)
    p = pt[..., :2] + P_EPS
    t = pt[..., 2:] + P_EPS
    p = p[..., :1] / (p[..., :1] + p[..., 1:2])
    t = t[..., :1] / (t[..., :1] + t[..., 1:2])
    t = (max_temp - min_temp) * t + min_temp
    k = torch.arange(n_bins, dtype=pt.dtype, device=pt.device)
    p = torch.clamp(p, 1e-4, 1.0)
    one_minus_p = torch.clamp(1.0 - p, 1e-4, 1.0)
    y = (_log_binom_table(n_bins, pt.device).to(pt.dtype) + k * torch.log(p)
         + (n_bins - 1 - k) * torch.log(one_minus_p))
    return p, t, one_minus_p, y


def log_binomial_depth_plain(pt, centers, n_bins: int, min_temp: float, max_temp: float):
    """Plain PyTorch version of :func:`log_binomial_depth` (any device)."""
    centers = _resized(centers, pt.shape[1:3])
    _, t, _, y = _log_binomial_logits(pt, n_bins, min_temp, max_temp)
    probs = torch.softmax(y / t, dim=-1)
    return torch.sum(probs * wide(centers), dim=-1, keepdim=True).to(pt.dtype)


# ---------------------------------------------------------------- backwards
def _resize_back(g, src_shape):
    """The gradient of the (B, h, w, C) ``src_shape`` centres from the
    gradient ``g`` (B, H, W, C) of their resize: the transpose of K2's taps
    (bilinear, align_corners), each output's gradient added into its two
    sources along W, then along H; ``g`` itself at equal sizes."""
    n, h, w, c = src_shape
    if tuple(g.shape[1:3]) == (h, w):
        return g
    for axis, size in ((2, w), (1, h)):
        idx, wt = _taps_on(size, g.shape[axis], "bilinear", True, None, g.device)
        shape = [1] * g.ndim
        shape[axis] = -1
        out_shape = list(g.shape)
        out_shape[axis] = size
        out = torch.zeros(out_shape, dtype=g.dtype, device=g.device)
        for t in range(idx.shape[0]):
            out.index_add_(axis, idx[t].long(), g * wt[t].view(shape))
        g = out
    return g


def attractor_backward(g_new, g_centers, a, b_prev, b_new, kind: str = "mean",
                       attractor_type: str = "inv", normed: bool = False, min_depth: float = 1e-3,
                       max_depth: float = 10.0):
    """(da, db_prev) of :func:`attractor_update` for the gradients of its
    outputs (``g_new`` of ``b_new``, ``g_centers`` of the normed centres;
    either may be None), from the inputs, the forward's ``b_new`` and the
    centres resized again by K2. With
    ``dist`` the attractor function (alpha 300, gamma 2), ``dist'(dx)`` is
    ``(1 - alpha dx^2) / (1 + alpha dx^2)^2`` (inv) or ``exp(-alpha dx^2)
    (1 - 2 alpha dx^2)`` (exp); the normed centres' gradient goes back
    through the clip (where the centre lies inside [min_depth, max_depth])
    and the sort (to each centre's bin before it)."""
    bc = wide(resize(b_prev, a.shape[1:3], "bilinear", True))
    dt = bc.dtype
    g = torch.zeros_like(bc) if g_new is None else wide(g_new).clone()
    if normed and g_centers is not None:
        c = (max_depth - min_depth) * wide(b_new) + min_depth
        sc, order = torch.sort(c, dim=-1)
        gs = wide(g_centers) * ((sc >= min_depth) & (sc <= max_depth))
        g += (max_depth - min_depth) * torch.zeros_like(gs).scatter_(-1, order, gs)
    dx = wide(a)[..., :, None] - bc[..., None, :]
    dx2 = dx * dx
    if attractor_type == "inv":
        den = 1 + ATTRACTOR_ALPHA * dx2
        dd = (1 - ATTRACTOR_ALPHA * dx2) / (den * den)
    else:
        dd = torch.exp(-ATTRACTOR_ALPHA * dx2) * (1 - 2 * ATTRACTOR_ALPHA * dx2)
    if kind == "mean":
        dd /= a.shape[-1]
    gd = g[..., None, :] * dd
    da = gd.sum(-1)
    g -= gd.sum(-2)
    return da.to(a.dtype), _resize_back(g, b_prev.shape).to(b_prev.dtype)


def log_binomial_backward(g, pt, centers, n_bins: int, min_temp: float, max_temp: float):
    """(dpt, dcenters) of :func:`log_binomial_depth` for the depth's
    gradient ``g`` (B, H, W, 1), with the probabilities (float32; float64
    for float64) and the centres' resize (K2) recomputed. For ``z = y / t``
    and the depth ``d = sum_k P_k c_k``: ``dc_k = g P_k``, ``dz_k = g P_k
    (c_k - d)``, then through the temperature, the two logarithms, the
    clips (where the value lies inside them) and the two ratios of ``pt``."""
    cu = wide(resize(centers, pt.shape[1:3], "bilinear", True))
    p, t, omp, y = _log_binomial_logits(pt, n_bins, min_temp, max_temp)
    probs = torch.softmax(y / t, dim=-1)
    g = wide(g)
    dcu = g * probs
    dz = dcu * (cu - (probs * cu).sum(-1, keepdim=True))
    del probs
    dy = dz / t
    dtemp = -(dz * y).sum(-1, keepdim=True) / (t * t)
    k = torch.arange(n_bins, dtype=dy.dtype, device=dy.device)
    dp = (dy * k).sum(-1, keepdim=True) / p
    domp = (dy * (n_bins - 1 - k)).sum(-1, keepdim=True) / omp
    one_minus = 1.0 - p
    dp = dp - domp * ((one_minus >= 1e-4) & (one_minus <= 1.0))
    pt_w = wide(pt)
    dp = dp * _raw_inside(pt_w[..., :2])
    dtraw = dtemp * (max_temp - min_temp)
    dpt = torch.cat([_ratio_back(dp, pt_w[..., :2]), _ratio_back(dtraw, pt_w[..., 2:])], dim=-1)
    return dpt.to(pt.dtype), _resize_back(dcu, centers.shape).to(centers.dtype)


def _raw_inside(pair):
    """1 where the ratio of the (x0, x1) ``pair`` (each plus P_EPS) lies
    inside the clip to [1e-4, 1], else 0."""
    a, b = pair[..., :1] + P_EPS, pair[..., 1:2] + P_EPS
    r = a / (a + b)
    return ((r >= 1e-4) & (r <= 1.0)).to(pair.dtype)


def _ratio_back(g, pair):
    """The gradient of the (x0, x1) ``pair`` from ``g``, the gradient of
    ``(x0 + eps) / (x0 + x1 + 2 eps)``."""
    a, b = pair[..., :1] + P_EPS, pair[..., 1:2] + P_EPS
    s2 = (a + b) * (a + b)
    return torch.cat([g * b / s2, -g * a / s2], dim=-1)


# ---------------------------------------------------------------- launch plans
def launch_plan(batch: int, out_hw, na: int, nb: int, itemsize: int, normed: bool = False,
                align: int = 16, sms: int = 132) -> dict:
    """The attractor kernel's plan for ``batch`` images of ``out_hw`` output
    pixels with ``nb`` bins and ``na`` attractors, elements of ``itemsize``
    bytes and centres aligned to ``align`` bytes, on a card of ``sms`` SMs.
    A thread holds ``vec`` bins of one pixel: 16 bytes' worth where that
    still gives the card ``THREADS_PER_SM`` threads an SM (the largest
    levels, where a thread's fixed work is then shared by more bins), else
    2 (a bf16x2 or float2 pair), else 1. A pixel's ``nb / vec`` bin groups
    lie on ``tpp`` consecutive lanes (a power of two, at most 256), each
    lane walking ``groups`` of them ``tpp`` apart. A block holds ``pix``
    consecutive pixels of an output row, as many as keep the grid, ``grid``
    = (row segments, rows, images), at one block an SM or more (at most 256
    threads); normed layers sort each pixel's centres in a row of ``np``
    floats (a power of two) of shared memory."""
    h_out, w_out = out_hw
    wide = 16 // itemsize
    if nb % wide == 0 and align % 16 == 0 and batch * h_out * w_out * (nb // wide) >= sms * THREADS_PER_SM:
        vec = wide
    elif nb % 2 == 0 and align % (2 * itemsize) == 0:
        vec = 2
    else:
        vec = 1
    lanes = nb // vec
    tpp = min(BLOCK_THREADS, 1 << (lanes - 1).bit_length())
    rows = batch * h_out
    pix = max([q for q in range(1, BLOCK_THREADS // tpp + 1) if rows * -(-w_out // q) >= sms] or [1])
    np_ = 1 << (nb - 1).bit_length() if normed else 0
    return dict(vec=vec, tpp=tpp, groups=-(-lanes // tpp), pix=pix, threads=pix * tpp,
                grid=(-(-w_out // pix), h_out, batch), np=np_, smem=4 * pix * np_)


def _column_taps(w: int, out: int) -> np.ndarray:
    """(2, out) source columns of each output column: its two taps, or
    itself at equal sizes."""
    if w == out:
        return np.stack([np.arange(out), np.arange(out)])
    return axis_taps(w, out, "bilinear", True)[0]


def log_binomial_plan(src_hw, out_hw, k: int, batch: int, itemsize: int, aligned: bool = True,
                      sms: int = 132) -> dict:
    """The log-binomial kernel's plan for centres of ``src_hw`` resized to
    ``out_hw`` with ``k`` bins. A block is a segment of ``bw`` pixels of an
    output row (128, 64 or 32: the widest whose grid holds a block an SM or
    more). ``staged``: the block resizes its segment's centres along H into
    shared memory over its ``cols`` source columns (``smem`` bytes), which
    needs K a multiple of 16 bytes' elements, 16-byte aligned centres and
    at most ``LB_SMEM`` bytes; else each thread gathers
    its four taps from device memory (a slower path no configuration
    takes). ``registers``: K = 64, the logits held in registers."""
    (_, w), (h_out, w_out) = src_hw, out_hw
    cols_of = _column_taps(w, w_out)
    widest = 32 * -(-w_out // 32)
    widths = sorted({min(b, widest) for b in (128, 64, 32)}, reverse=True)
    full = [b for b in widths if batch * h_out * -(-w_out // b) >= sms] or widths[-1:]
    for bw in full:
        starts = np.arange(0, w_out, bw)
        ends = np.minimum(starts + bw, w_out) - 1
        cols = int((cols_of[1][ends] - cols_of[0][starts]).max()) + 1
        smem = 4 * cols * (k + 4)
        if aligned and k % (16 // itemsize) == 0 and smem <= LB_SMEM:
            return dict(bw=bw, staged=True, cols=cols, smem=smem, registers=k == 64,
                        grid=(len(starts), h_out, batch))
    bw = full[0]
    return dict(bw=bw, staged=False, cols=0, smem=0, registers=k == 64,
                grid=(-(-w_out // bw), h_out, batch))


def _taps(src_hw, out_hw, device):
    """The kernels' packed row and column taps of src_hw -> out_hw, or
    (None, None) at equal sizes."""
    if tuple(src_hw) == tuple(out_hw):
        return None, None
    return (_packed_taps_on(int(src_hw[0]), int(out_hw[0]), "bilinear", True, None, device),
            _packed_taps_on(int(src_hw[1]), int(out_hw[1]), "bilinear", True, None, device))


def _check_nhwc(x: torch.Tensor, y: torch.Tensor, names: str) -> None:
    if x.ndim != 4 or y.ndim != 4 or x.shape[0] != y.shape[0]:
        raise ValueError(f"{names}: expected NHWC tensors of one batch, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")


# ---------------------------------------------------------------- kernels
def attractor_update(a: torch.Tensor, b_prev: torch.Tensor, kind: str = "mean",
                     attractor_type: str = "inv", normed: bool = False, min_depth: float = 1e-3,
                     max_depth: float = 10.0):
    """Attractor shift of the bin centres. ``a``: (B, H, W, na) attractor
    points; ``b_prev``: (B, h, w, nb), the previous centres, resized to (H,
    W) here (bilinear, align_corners) unless they are at that size. Returns
    ``(b_new, centers)``, both (B, H, W, nb): ``centers`` is ``b_new`` for
    unnormed layers, and ``b_new`` scaled to [min_depth, max_depth], sorted
    and clipped for normed ones."""
    if kind not in ("mean", "sum") or attractor_type not in ("inv", "exp"):
        raise ValueError(f"unknown attractor kind {kind!r} or type {attractor_type!r}")
    args = (kind, attractor_type, bool(normed), float(min_depth), float(max_depth))
    if wants_grad(a, b_prev):
        require_float("attractor_update", a, b_prev)
        out = _Attractor.apply(a, b_prev, *args)
        return out if normed else (out[0], out[0])
    return _attractor_forward(a, b_prev, *args)


def _attractor_forward(a, b_prev, kind, attractor_type, normed, min_depth, max_depth):
    if _cuda.on_cpu(a):
        return _flops.plain(attractor_update_plain, a, b_prev, kind, attractor_type, normed,
                            min_depth, max_depth)
    _check_nhwc(a, b_prev, "a and b_prev")
    (bsz, oh, ow, na), (_, h, w, nb) = a.shape, b_prev.shape
    if nb > MAX_BINS or na < 1:
        raise ValueError(f"attractor kernel takes 1 to {MAX_BINS} bins and an attractor, got {nb}, {na}")
    _cuda.require_cuda(a, b_prev)
    dt = _cuda.dtype_code(b_prev.dtype)
    if a.dtype != b_prev.dtype:
        raise ValueError("a and b_prev must share a dtype")
    plan = launch_plan(bsz, (oh, ow), na, nb, a.element_size(), normed, _alignment(b_prev),
                       _cuda.sms(a.device))
    b_new = torch.empty((bsz, oh, ow, nb), dtype=a.dtype, device=a.device)
    centers = torch.empty_like(b_new) if normed else b_new
    ty, tx = _taps((h, w), (oh, ow), a.device)
    fn = _cuda.bind("bins", "prv2_attractor", 6, 15, 3)
    rc = fn(_cuda.ptr(a), _cuda.ptr(b_prev), _cuda.ptr(b_new), _cuda.ptr(centers), _cuda.ptr(ty),
            _cuda.ptr(tx), bsz, oh, ow, h, w, na, nb, plan["vec"], plan["tpp"], plan["pix"],
            plan["groups"], plan["np"], int(attractor_type == "inv"),
            int(kind == "mean"), int(bool(normed)), float(min_depth), float(max_depth),
            float(max_depth - min_depth), dt, _cuda.stream_of(a))
    _cuda.check(rc, "attractor_update")
    attractor_update.launches += 1
    return b_new, centers


class _Attractor(torch.autograd.Function):
    """Outputs (b_new,) of an unnormed layer, (b_new, centers) of a normed one."""

    @staticmethod
    def forward(ctx, a, b_prev, kind, attractor_type, normed, min_depth, max_depth):
        b_new, centers = _attractor_forward(a, b_prev, kind, attractor_type, normed, min_depth,
                                            max_depth)
        ctx.save_for_backward(a, b_prev, b_new)
        ctx.args = (kind, attractor_type, normed, min_depth, max_depth)
        return (b_new, centers) if normed else (b_new,)

    @staticmethod
    def backward(ctx, g_new, g_centers=None):
        a, b_prev, b_new = ctx.saved_tensors
        da, db = attractor_backward(g_new, g_centers, a, b_prev, b_new, *ctx.args)
        return da, db, None, None, None, None, None


attractor_update.launches = 0


def log_binomial_depth(pt: torch.Tensor, centers: torch.Tensor, n_bins: int, min_temp: float,
                       max_temp: float) -> torch.Tensor:
    """Depth (B, H, W, 1) from the softplus output ``pt`` (B, H, W, 4) of
    ``ConditionalLogBinomial`` and the bin centres (B, h, w, K), resized to
    (H, W) here (bilinear, align_corners) unless they are at that size: the
    expectation of the centres under the softmax over the K bins of the
    binomial log-probabilities divided by the temperature."""
    args = (int(n_bins), float(min_temp), float(max_temp))
    if wants_grad(pt, centers):
        require_float("log_binomial_depth", pt, centers)
        return _LogBinomial.apply(pt, centers, *args)
    return _log_binomial_forward(pt, centers, *args)


def _log_binomial_forward(pt, centers, n_bins, min_temp, max_temp):
    if _cuda.on_cpu(pt):
        return _flops.plain(log_binomial_depth_plain, pt, centers, n_bins, min_temp, max_temp)
    _check_nhwc(pt, centers, "pt and centers")
    (bsz, oh, ow, four), (_, h, w, k) = pt.shape, centers.shape
    if four != 4 or k != n_bins:
        raise ValueError(f"expected (B, H, W, 4) and (B, h, w, {n_bins}), got {tuple(pt.shape)}, "
                         f"{tuple(centers.shape)}")
    if n_bins > MAX_BINS:
        raise ValueError(f"log-binomial kernel takes at most {MAX_BINS} bins, got {n_bins}")
    _cuda.require_cuda(pt, centers)
    dt = _cuda.dtype_code(pt.dtype)
    if centers.dtype != pt.dtype:
        raise ValueError("pt and centers must share a dtype")
    if pt.data_ptr() % (4 * pt.element_size()):
        raise ValueError("log-binomial kernel reads pt a pixel (4 elements) at a time: it must be aligned to it")
    plan = log_binomial_plan((h, w), (oh, ow), k, bsz, pt.element_size(), _alignment(centers) == 16,
                             _cuda.sms(pt.device))
    out = torch.empty((bsz, oh, ow, 1), dtype=pt.dtype, device=pt.device)
    ty, tx = _taps((h, w), (oh, ow), pt.device)
    fn = _cuda.bind("bins", "prv2_log_binomial", 7, 9, 2)
    rc = fn(_cuda.ptr(pt), _cuda.ptr(centers), _cuda.ptr(_log_binom_table(k, pt.device)),
            _cuda.ptr(_log_binom_table(k, torch.device("cpu"))), _cuda.ptr(out), _cuda.ptr(ty),
            _cuda.ptr(tx), bsz, oh, ow, h, w, k, plan["bw"], int(plan["staged"]), plan["cols"],
            float(min_temp), float(max_temp - min_temp), dt, _cuda.stream_of(pt))
    _cuda.check(rc, "log_binomial_depth")
    log_binomial_depth.launches += 1
    return out


class _LogBinomial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pt, centers, n_bins, min_temp, max_temp):
        ctx.save_for_backward(pt, centers)
        ctx.args = (n_bins, min_temp, max_temp)
        return _log_binomial_forward(pt.contiguous(), centers.contiguous(), n_bins, min_temp,
                                     max_temp)

    @staticmethod
    def backward(ctx, g):
        pt, centers = ctx.saved_tensors
        dpt, dc = log_binomial_backward(g, pt, centers, *ctx.args)
        return dpt, dc, None, None, None


log_binomial_depth.launches = 0
