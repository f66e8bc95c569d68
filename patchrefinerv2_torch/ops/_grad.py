"""Gradients of the kernel wrappers.

K2 (bilinear resize), K5 (gate tail), K6 (LayerNorm) and K9 (tail conv)
are ``torch.autograd.Function``s: the forward is the hand-written kernel on
a CUDA tensor (the plain version on a CPU tensor), the backward is the
gradient written out in PyTorch ops, the same on both devices. The JAX
package has no custom VJP: XLA differentiates its hand-formulated
forwards, and these backwards are the counterparts of what it derives.
The other kernels have no backward; their wrappers raise when they are
asked for a gradient (:func:`forbid_grad`), so that no path trains without
one silently.
"""

from __future__ import annotations

import torch

__all__ = ["wants_grad", "forbid_grad", "require_float", "wide", "ln_stats", "ln_backward"]


def wants_grad(*tensors) -> bool:
    """True when autograd records and one of ``tensors`` requires a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def forbid_grad(name: str, *tensors) -> None:
    """Raise when a gradient is asked of a kernel that has no backward."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward in the port: call it under torch.no_grad() or on inputs "
            "that require no gradient")


def require_float(name: str, *tensors) -> None:
    """Gradients are taken in float32, the training dtype (float64 reaches
    only the plain versions, on the CPU: the kernels take no float64)."""
    ok = (torch.float32, torch.float64)
    bad = sorted({str(t.dtype) for t in tensors if t is not None and t.dtype not in ok})
    if bad:
        raise TypeError(f"{name} takes a gradient in float32 (or float64 on the CPU), got {bad}")


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its compute dtype: float32 for bfloat16 and float32, float64
    for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def ln_stats(x: torch.Tensor, eps: float):
    """(mean, rstd, var_positive) of float32 rows ``x`` (M, C), as the
    forward's fast variance ``max(E[x^2] - mean^2, 0)`` computes them."""
    mean = x.mean(-1, keepdim=True)
    raw = (x * x).mean(-1, keepdim=True) - mean * mean
    return mean, torch.rsqrt(torch.clamp(raw, min=0.0) + eps), raw > 0


def ln_backward(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float):
    """Gradients of ``y = (x - mean) * (rstd * weight) + bias`` over float32
    rows ``x`` (M, C) for the output gradient ``g`` (M, C): (dx, dweight,
    dbias). Where ``E[x^2] - mean^2`` is not positive the clamp passes no
    gradient to the variance."""
    mean, rstd, pos = ln_stats(x, eps)
    xhat = (x - mean) * rstd
    gw = g * weight
    proj = (gw * xhat).mean(-1, keepdim=True) * pos
    dx = rstd * (gw - gw.mean(-1, keepdim=True) - xhat * proj)
    return dx, (g * xhat).sum(0), g.sum(0)
