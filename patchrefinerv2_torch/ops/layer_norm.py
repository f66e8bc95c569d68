"""K6: row LayerNorm over the last axis with float32 statistics.

Counterpart of three JAX forms that compute the same function:
``DotLayerNorm`` (``patchrefinerv2_tpu/models/blocks/convs.py:18``, the
channel LN written as dot products with a ones vector to keep the TPU conv
layout), ``_layer_norm`` (``blocks/dpt.py:84``) and the BEiT
``nn.LayerNorm`` (``backbones/beit.py:168,171``). All use the fast-variance
formula ``var = max(E[x^2] - mean^2, 0)`` and
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``; the output keeps the
input's dtype.

On Hopper a channel LN over NHWC (channels_last) activations is a plain
row reduction over contiguous channels. The Triton kernel (built at first
use; ``triton`` is imported only inside the launcher) loads a block of
rows, reduces each row in float32 registers and writes the affine result.
It is bound by bytes: each element is read once and written once. On a CPU
tensor :func:`layer_norm` runs :func:`layer_norm_plain`.
``layer_norm.launches`` counts the kernel launches.

Under autograd :func:`layer_norm` is a ``torch.autograd.Function``
(``_LayerNorm``): the forward as above, the backward in PyTorch ops from
the saved input (mean and rstd recomputed, ``ops/_grad.ln_backward``).
"""

from __future__ import annotations

import functools

import torch

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops._grad import ln_backward, require_float, wants_grad, wide

__all__ = ["layer_norm", "layer_norm_plain"]


def layer_norm_plain(x, weight, bias, eps: float = 1e-6):
    """Plain PyTorch version of :func:`layer_norm` (any device)."""
    xf = wide(x)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * wide(weight)) + wide(bias)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_rows(X, Wt, B, Y, M, C, eps, BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        mask = (rows < M)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / C
        var = tl.maximum(tl.sum(x * x, axis=1) / C - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(Wt + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=cmask, other=0.0).to(tl.float32)
        y = (x - mean[:, None]) * (rstd[:, None] * w[None, :]) + b[None, :]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)

    return triton, ln_rows


def _blocks(c: int):
    block_c = 1 << max(0, (c - 1).bit_length())
    block_m = max(1, min(128, 4096 // block_c))
    num_warps = 4 if block_c * block_m <= 4096 else 8
    return block_m, block_c, num_warps


def _forward(x, weight, bias, eps):
    if _cuda.on_cpu(x):
        return _flops.plain(layer_norm_plain, x, weight, bias, eps)
    c = x.shape[-1]
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"expected ({c},) weight and bias, got {tuple(weight.shape)}, {tuple(bias.shape)}")
    _cuda.require_cuda(x, weight, bias)
    _cuda.dtype_code(x.dtype)
    if c > 8192:
        raise ValueError(f"layer_norm kernel takes rows of at most 8192 channels, got {c}")
    m = x.numel() // c
    y = torch.empty_like(x)
    triton, kern = _kernel()
    block_m, block_c, num_warps = _blocks(c)
    kern[(triton.cdiv(m, block_m),)](
        x, weight, bias, y, m, c, float(eps),
        BLOCK_M=block_m, BLOCK_C=block_c, num_warps=num_warps)
    layer_norm.launches += 1
    return y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        c = x.shape[-1]
        dx, dw, db = ln_backward(gy.reshape(-1, c), x.reshape(-1, c), weight, ctx.eps)
        return dx.reshape(x.shape), dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape)."""
    if wants_grad(x, weight, bias):
        require_float("layer_norm", x, weight, bias)
        return _LayerNorm.apply(x.contiguous(), weight, bias, eps)
    return _forward(x, weight, bias, eps)


layer_norm.launches = 0
