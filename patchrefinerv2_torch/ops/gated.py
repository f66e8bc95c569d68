"""K5: the GatedConvUnit tail, ``y = out * sigmoid(W . relu(LN(f)))`` (gate
on) or ``y = W . relu(LN(f))`` (gate off), over channels_last rows.

Counterpart of ``patchrefinerv2_tpu/models/blocks/dpt.py:96``
``GatedConvUnit`` after its 3x3 fusion conv (:188-193): ``_layer_norm``
(eps 1e-6, fast variance ``max(E[x^2] - mean^2, 0)``, float32 statistics),
ReLU, the bias-free 1x1 conv, and the sigmoid gate on the residual branch
``out``. The LN output, the 1x1 output and the sigmoid are each rounded to
the input dtype, as the JAX package's ops round them.

On a CUDA tensor :func:`gate_tail` launches the kernel of
``csrc/gated_conv.cu`` (or raises), which reads ``f`` and ``out`` once and
writes ``y`` once: the LN output and the 1x1 output stay in shared memory
and registers. In bfloat16 it is a persistent kernel that streams tiles of
``f`` through a ring in shared memory and runs the 1x1 on ``wgmma``;
:func:`launch_plan` sizes its tiles, ring and grid. On a CPU tensor it runs
:func:`gate_tail_plain`. ``gate_tail.launches`` counts the kernel launches.

Under autograd :func:`gate_tail` is a ``torch.autograd.Function``
(``_GateTail``): the forward as above, the backward in PyTorch ops from the
saved inputs (the LayerNorm, the 1x1 and the sigmoid recomputed, the 1x1's
gradients as two matmuls).
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops._grad import ln_backward, ln_stats, require_float, wants_grad, wide
from patchrefinerv2_torch.ops.layer_norm import layer_norm_plain

__all__ = ["gate_tail", "gate_tail_plain"]

# the configurations' GatedConvUnit widths: c2f_features 256, and head2
# (coarse_chl[0]) 32 in the ZoeDepth flagship, 128 in Depth-Anything-V2
CHANNELS = (32, 128, 256)
SMEM_MAX = 232448  # shared memory a block can have (bytes)
MAX_STAGES = 8
# alignment, the ring's barriers, the LayerNorm's scale and bias
FIXED = 128 + 128 + 1024


def launch_plan(rows: int, c: int, sms: int = 132) -> dict:
    """The bfloat16 kernel's plan for ``rows`` rows of ``c`` channels on a
    card of ``sms`` SMs: a tile of ``tile_rows`` rows (one m64 block, four
    at C = 32, where a row is 64 bytes), ``stages`` f tiles in the ring
    beside the resident W (as many as fit, at most 8), one block of 384
    threads per SM (``grid``: the SMs, or the tiles where fewer) and its
    shared memory ``smem``."""
    if c not in CHANNELS:
        raise ValueError(f"gate_tail kernel takes {CHANNELS} channels, got {c}")
    tile_rows = 256 if c == 32 else 64
    stage = tile_rows * c * 2
    stages = min(MAX_STAGES, (SMEM_MAX - FIXED - c * c * 2) // stage)
    tiles = -(-rows // tile_rows)
    return dict(tile_rows=tile_rows, stages=stages, smem=FIXED + c * c * 2 + stages * stage,
                tiles=tiles, grid=max(1, min(tiles, sms)))


def gate_tail_plain(f, out, weight, ln_weight, ln_bias, eps: float = 1e-6):
    """Plain PyTorch version of :func:`gate_tail` (any device)."""
    h = torch.relu(layer_norm_plain(f, ln_weight, ln_bias, eps))
    w = weight.reshape(weight.shape[0], -1)
    z = torch.matmul(wide(h), wide(w).t()).to(f.dtype)
    return z if out is None else out * torch.sigmoid(z)


def gate_tail(f: torch.Tensor, out: torch.Tensor | None, weight: torch.Tensor,
              ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``f``, ``out``: (..., C) rows (NHWC); ``out=None`` turns the gate off
    and returns the 1x1 output. ``weight``: the (C, C) or (C, C, 1, 1) 1x1
    conv weight; ``ln_weight``, ``ln_bias``: (C,)."""
    if wants_grad(f, out, weight, ln_weight, ln_bias):
        require_float("gate_tail", f, out, weight, ln_weight, ln_bias)
        return _GateTail.apply(f.contiguous(), None if out is None else out.contiguous(), weight,
                               ln_weight, ln_bias, eps)
    return _forward(f, out, weight, ln_weight, ln_bias, eps)


def _forward(f, out, weight, ln_weight, ln_bias, eps):
    _flops.add("gate_tail", 2 * f.numel() * weight.shape[0])  # the 1x1
    if _cuda.on_cpu(f):
        return _flops.plain(gate_tail_plain, f, out, weight, ln_weight, ln_bias, eps)
    c = f.shape[-1]
    if c not in CHANNELS:
        raise ValueError(f"gate_tail kernel takes {CHANNELS} channels, got {c}")
    w = weight.reshape(c, -1)
    if w.shape != (c, c) or tuple(ln_weight.shape) != (c,) or tuple(ln_bias.shape) != (c,):
        raise ValueError(f"expected a ({c}, {c}) weight and ({c},) LayerNorm parameters, got "
                         f"{tuple(weight.shape)}, {tuple(ln_weight.shape)}, {tuple(ln_bias.shape)}")
    if out is not None and out.shape != f.shape:
        raise ValueError(f"out {tuple(out.shape)} and f {tuple(f.shape)} differ")
    tensors = [f, w, ln_weight, ln_bias] + ([out] if out is not None else [])
    _cuda.require_cuda(*tensors)
    if any(t.dtype != f.dtype for t in tensors):
        raise ValueError("gate_tail takes every tensor in one dtype")
    if any(t.data_ptr() % 16 for t in (f, out, w) if t is not None):
        raise ValueError("gate_tail reads f, out and the weight 16 bytes at a time: they must be "
                         "16-byte aligned")
    dt = _cuda.dtype_code(f.dtype)
    y = torch.empty_like(f)
    rows = f.numel() // c
    plan = launch_plan(rows, c, _cuda.sms(f.device)) if f.dtype == torch.bfloat16 else dict(stages=0, grid=0)
    fn = _cuda.bind("gated_conv", "prv2_gate_tail", 6, 4, 1)
    rc = fn(_cuda.ptr(f), _cuda.ptr(out), _cuda.ptr(w), _cuda.ptr(ln_weight), _cuda.ptr(ln_bias),
            _cuda.ptr(y), rows, c, plan["stages"], plan["grid"], float(eps), dt, _cuda.stream_of(f))
    _cuda.check(rc, "gate_tail")
    gate_tail.launches += 1
    return y


class _GateTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, out, weight, ln_weight, ln_bias, eps):
        ctx.save_for_backward(f, out, weight, ln_weight, ln_bias)
        ctx.eps = eps
        return _forward(f, out, weight, ln_weight, ln_bias, eps)

    @staticmethod
    def backward(ctx, gy):
        f, out, weight, lw, lb = ctx.saved_tensors
        c = f.shape[-1]
        x = f.reshape(-1, c)
        mean, rstd, _ = ln_stats(x, ctx.eps)
        ln = (x - mean) * (rstd * lw) + lb
        h = torch.relu(ln)
        w = weight.reshape(c, c)
        g = gy.reshape(-1, c)
        dout = None
        if out is None:
            dz = g
        else:
            s = torch.sigmoid(torch.matmul(h, w.t()))
            dz = g * out.reshape(-1, c) * (s * (1.0 - s))
            if ctx.needs_input_grad[1]:
                dout = (g * s).reshape(out.shape)
        dw = torch.matmul(dz.t(), h).reshape(weight.shape)
        dln = torch.matmul(dz, w) * (ln > 0)
        df, dlw, dlb = ln_backward(dln, x, lw, ctx.eps)
        return df.reshape(f.shape), dout, dw, dlw, dlb, None


gate_tail.launches = 0
