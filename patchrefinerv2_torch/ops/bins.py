"""K8: the ZoeDepth bins head's per-pixel math, two Triton kernels.

Counterpart of ``patchrefinerv2_tpu/models/backbones/zoedepth.py``:

- :func:`attractor_update` -- the attractor shift of the bin centres,
  ``b_new = b_centers + reduce_na(dist(a - b_centers))`` (``exp_attractor``
  :39, ``inv_attractor`` :44, ``AttractorLayerUnnormed`` :117-132,
  ``AttractorLayerNormed`` :149-170). The reference quirk is kept: ``dist``
  runs with alpha 300 and gamma 2 whatever the config says (:49-56). Normed
  layers also return the centres scaled to [min_depth, max_depth], sorted
  and clipped.
- :func:`log_binomial_depth` -- from the softplus ``pt`` of
  ``ConditionalLogBinomial`` (:195-217) to the depth: the binomial
  log-probabilities (``log_binom`` :173 with xlogy semantics), the softmax
  over the K bins with the temperature, and the expectation over the
  upsampled centres (:375-376).

Layout: channels last ((..., na), (..., nb), (..., 4), (..., K)). The
attractor math runs in the input dtype, as the JAX layers write it: each
elementwise step is rounded to it, and the reduction over the attractors
accumulates in float32. The log-binomial math runs in float32 and only the
depth is rounded to the input dtype. On a CUDA
tensor the functions launch their kernel (or raise): one program per block
of pixels holds the pixels' bins in registers, so neither the
(B, H, W, na, nb) attractor differences nor the (B, H, W, K) probabilities
are written; both kernels are bound by bytes (each input read once, each
output written once). On a CPU tensor they run their plain versions.
``attractor_update.launches`` and ``log_binomial_depth.launches`` count the
launches.

The log-binomial softmax divides logits of magnitude up to ~600 by a
temperature down to ``min_temp`` (0.0212 in the flagship), so a 1-ulp
difference in a logarithm can move a probability by ~1e-4 relative: the
kernels call libdevice's ``log``, ``exp`` and correctly rounded division,
the functions PyTorch's CUDA ops use, to stay within that of the plain
versions.
"""

from __future__ import annotations

import functools

import torch

from patchrefinerv2_torch.ops import _cuda

__all__ = ["attractor_update", "attractor_update_plain", "log_binomial_depth",
           "log_binomial_depth_plain"]

ATTRACTOR_ALPHA = 300.0  # attractor.py's jit-script default, used whatever the config says
P_EPS = 1e-4


# ---------------------------------------------------------------- plain versions
def _dist(dx, attractor_type: str):
    if attractor_type == "inv":
        return dx / (1 + ATTRACTOR_ALPHA * dx ** 2)
    return torch.exp(-ATTRACTOR_ALPHA * torch.abs(dx) ** 2) * dx


def attractor_update_plain(a, b_centers, kind: str = "mean", attractor_type: str = "inv",
                           normed: bool = False, min_depth: float = 1e-3, max_depth: float = 10.0):
    """Plain PyTorch version of :func:`attractor_update` (any device), in
    the input dtype as the JAX layers compute it."""
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
    """log_binom(K - 1, k) for k = 0 .. K - 1, float32: a constant of K."""
    idx = torch.arange(k, dtype=torch.float32)
    return log_binom(torch.tensor(k - 1, dtype=torch.float32), idx).to(device)


def log_binomial_depth_plain(pt, centers, n_bins: int, min_temp: float, max_temp: float):
    """Plain PyTorch version of :func:`log_binomial_depth` (any device)."""
    pt32 = pt.float()
    p = pt32[..., :2] + P_EPS
    t = pt32[..., 2:] + P_EPS
    p = p[..., :1] / (p[..., :1] + p[..., 1:2])
    t = t[..., :1] / (t[..., :1] + t[..., 1:2])
    t = (max_temp - min_temp) * t + min_temp
    k = torch.arange(n_bins, dtype=torch.float32, device=pt.device)
    p = torch.clamp(p, 1e-4, 1.0)
    one_minus_p = torch.clamp(1.0 - p, 1e-4, 1.0)
    y = (_log_binom_table(n_bins, pt.device) + k * torch.log(p)
         + (n_bins - 1 - k) * torch.log(one_minus_p))
    probs = torch.softmax(y / t, dim=-1)
    return torch.sum(probs * centers.float(), dim=-1, keepdim=True).to(pt.dtype)


# ---------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def attractor_kernel(A, Bc, Bn, Cen, P, NA, NB, na_f, alpha, lo, hi, span,
                         BLOCK_P: tl.constexpr, BLOCK_B: tl.constexpr, INV: tl.constexpr,
                         MEAN: tl.constexpr, NORMED: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_B)
        rmask = rows < P
        cmask = cols < NB
        mask = rmask[:, None] & cmask[None, :]
        rows64 = rows.to(tl.int64)
        offs = rows64[:, None] * NB + cols[None, :]
        dt = Bc.dtype.element_ty  # every step is rounded to it, as the eager ops round
        b = tl.load(Bc + offs, mask=mask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK_P, BLOCK_B], dtype=tl.float32)
        for i in range(0, NA):
            a = tl.load(A + rows64 * NA + i, mask=rmask, other=0.0).to(tl.float32)
            dx = (a[:, None] - b).to(dt).to(tl.float32)
            if INV:
                den = (alpha * (dx * dx).to(dt).to(tl.float32)).to(dt).to(tl.float32)
                den = (1.0 + den).to(dt).to(tl.float32)
                acc += libdevice.div_rn(dx, den).to(dt).to(tl.float32)
            else:
                ad = tl.abs(dx)
                e = (-alpha * (ad * ad).to(dt).to(tl.float32)).to(dt).to(tl.float32)
                e = libdevice.exp(e).to(dt).to(tl.float32)
                acc += (e * dx).to(dt).to(tl.float32)
        if MEAN:
            acc = libdevice.div_rn(acc, na_f)
        b_new = (b + acc.to(dt).to(tl.float32)).to(dt).to(tl.float32)
        tl.store(Bn + offs, b_new.to(dt), mask=mask)
        if NORMED:
            c = (span * b_new).to(dt).to(tl.float32)
            c = (c + lo).to(dt).to(tl.float32)
            c = tl.where(cmask[None, :], c, float("inf"))
            c = tl.sort(c, dim=1)
            c = tl.minimum(tl.maximum(c, lo), hi)
            tl.store(Cen + offs, c.to(dt), mask=mask)

    @triton.jit
    def log_binomial_kernel(PT, Cen, LB, Out, P, K, min_temp, span, BLOCK_P: tl.constexpr,
                            BLOCK_K: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_K)
        rmask = rows < P
        cmask = cols < K
        mask = rmask[:, None] & cmask[None, :]
        rows64 = rows.to(tl.int64)
        p0 = tl.load(PT + rows64 * 4, mask=rmask, other=1.0).to(tl.float32) + 1e-4
        p1 = tl.load(PT + rows64 * 4 + 1, mask=rmask, other=1.0).to(tl.float32) + 1e-4
        t0 = tl.load(PT + rows64 * 4 + 2, mask=rmask, other=1.0).to(tl.float32) + 1e-4
        t1 = tl.load(PT + rows64 * 4 + 3, mask=rmask, other=1.0).to(tl.float32) + 1e-4
        p = libdevice.div_rn(p0, p0 + p1)
        t = span * libdevice.div_rn(t0, t0 + t1) + min_temp
        p = tl.minimum(tl.maximum(p, 1e-4), 1.0)
        q = tl.minimum(tl.maximum(1.0 - p, 1e-4), 1.0)
        k = cols.to(tl.float32)
        lb = tl.load(LB + cols, mask=cmask, other=0.0)
        y = (lb[None, :] + k[None, :] * libdevice.log(p)[:, None]
             + ((K - 1) - k)[None, :] * libdevice.log(q)[:, None])
        y = libdevice.div_rn(y, t[:, None])
        y = tl.where(cmask[None, :], y, float("-inf"))
        e = libdevice.exp(y - tl.max(y, axis=1)[:, None])
        e = tl.where(cmask[None, :], e, 0.0)
        prob = libdevice.div_rn(e, tl.sum(e, axis=1)[:, None])
        c = tl.load(Cen + rows64[:, None] * K + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        depth = tl.sum(prob * c, axis=1)
        tl.store(Out + rows64, depth.to(Out.dtype.element_ty), mask=rmask)

    return triton, attractor_kernel, log_binomial_kernel


def _blocks(width: int):
    block = 1 << max(0, (width - 1).bit_length())
    return max(1, min(128, 4096 // block)), block


def attractor_update(a: torch.Tensor, b_centers: torch.Tensor, kind: str = "mean",
                     attractor_type: str = "inv", normed: bool = False, min_depth: float = 1e-3,
                     max_depth: float = 10.0):
    """Attractor shift of the bin centres. ``a``: (..., na) attractor points,
    ``b_centers``: (..., nb) centres at the same pixels. Returns
    ``(b_new, centers)``, both (..., nb): ``centers`` is ``b_new`` for
    unnormed layers, and ``b_new`` scaled to [min_depth, max_depth], sorted
    and clipped for normed ones."""
    if kind not in ("mean", "sum") or attractor_type not in ("inv", "exp"):
        raise ValueError(f"unknown attractor kind {kind!r} or type {attractor_type!r}")
    if _cuda.on_cpu(a):
        return attractor_update_plain(a, b_centers, kind, attractor_type, normed, min_depth, max_depth)
    na, nb = a.shape[-1], b_centers.shape[-1]
    if a.shape[:-1] != b_centers.shape[:-1]:
        raise ValueError(f"a {tuple(a.shape)} and b_centers {tuple(b_centers.shape)} differ in pixels")
    if nb > 1024:
        raise ValueError(f"attractor kernel takes at most 1024 bins, got {nb}")
    _cuda.require_cuda(a, b_centers)
    _cuda.dtype_code(b_centers.dtype)
    if a.dtype != b_centers.dtype:
        raise ValueError("a and b_centers must share a dtype")
    p = b_centers.numel() // nb
    b_new = torch.empty_like(b_centers)
    centers = torch.empty_like(b_centers) if normed else b_new
    triton, kern, _ = _kernels()
    block_p, block_b = _blocks(nb)
    kern[(triton.cdiv(p, block_p),)](
        a, b_centers, b_new, centers, p, na, nb, float(na), ATTRACTOR_ALPHA, float(min_depth),
        float(max_depth), float(max_depth - min_depth), BLOCK_P=block_p, BLOCK_B=block_b, INV=attractor_type == "inv",
        MEAN=kind == "mean", NORMED=bool(normed), num_warps=4)
    attractor_update.launches += 1
    return b_new, centers


attractor_update.launches = 0


def log_binomial_depth(pt: torch.Tensor, centers: torch.Tensor, n_bins: int, min_temp: float,
                       max_temp: float) -> torch.Tensor:
    """Depth (..., 1) from the softplus output ``pt`` (..., 4) of
    ``ConditionalLogBinomial`` and the bin centres (..., K) at the same
    pixels: the expectation of the centres under the softmax over the K
    bins of the binomial log-probabilities divided by the temperature."""
    if _cuda.on_cpu(pt):
        return log_binomial_depth_plain(pt, centers, n_bins, min_temp, max_temp)
    if pt.shape[-1] != 4 or centers.shape[-1] != n_bins or pt.shape[:-1] != centers.shape[:-1]:
        raise ValueError(f"expected (..., 4) and (..., {n_bins}), got {tuple(pt.shape)}, {tuple(centers.shape)}")
    if n_bins > 1024:
        raise ValueError(f"log-binomial kernel takes at most 1024 bins, got {n_bins}")
    _cuda.require_cuda(pt, centers)
    _cuda.dtype_code(pt.dtype)
    if centers.dtype != pt.dtype:
        raise ValueError("pt and centers must share a dtype")
    p = centers.numel() // n_bins
    out = torch.empty(pt.shape[:-1] + (1,), dtype=pt.dtype, device=pt.device)
    triton, _, kern = _kernels()
    block_p, block_k = _blocks(n_bins)
    kern[(triton.cdiv(p, block_p),)](
        pt, centers, _log_binom_table(n_bins, pt.device), out, p, n_bins, float(min_temp),
        float(max_temp - min_temp), BLOCK_P=block_p, BLOCK_K=block_k, num_warps=4)
    log_binomial_depth.launches += 1
    return out


log_binomial_depth.launches = 0
