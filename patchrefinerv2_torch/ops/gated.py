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
and registers. On a CPU tensor it runs :func:`gate_tail_plain`.
``gate_tail.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops import _cuda
from patchrefinerv2_torch.ops.layer_norm import layer_norm_plain

__all__ = ["gate_tail", "gate_tail_plain"]

# the configurations' GatedConvUnit widths: c2f_features 256, and head2
# (coarse_chl[0]) 32 in the ZoeDepth flagship, 128 in Depth-Anything-V2
CHANNELS = (32, 128, 256)


def gate_tail_plain(f, out, weight, ln_weight, ln_bias, eps: float = 1e-6):
    """Plain PyTorch version of :func:`gate_tail` (any device)."""
    h = torch.relu(layer_norm_plain(f, ln_weight, ln_bias, eps))
    w = weight.reshape(weight.shape[0], -1)
    z = torch.matmul(h.float(), w.float().t()).to(f.dtype)
    return z if out is None else out * torch.sigmoid(z)


def gate_tail(f: torch.Tensor, out: torch.Tensor | None, weight: torch.Tensor,
              ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``f``, ``out``: (..., C) rows (NHWC); ``out=None`` turns the gate off
    and returns the 1x1 output. ``weight``: the (C, C) or (C, C, 1, 1) 1x1
    conv weight; ``ln_weight``, ``ln_bias``: (C,)."""
    if _cuda.on_cpu(f):
        return gate_tail_plain(f, out, weight, ln_weight, ln_bias, eps)
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
    if any(t.data_ptr() % 16 for t in (f, out) if t is not None):
        raise ValueError("gate_tail reads f and out 16 bytes at a time: they must be 16-byte aligned")
    dt = _cuda.dtype_code(f.dtype)
    y = torch.empty_like(f)
    fn = _cuda.bind("gated_conv", "prv2_gate_tail", 6, 2, 1)
    rc = fn(_cuda.ptr(f), _cuda.ptr(out), _cuda.ptr(w), _cuda.ptr(ln_weight), _cuda.ptr(ln_bias),
            _cuda.ptr(y), f.numel() // c, c, float(eps), dt, _cuda.stream_of(f))
    _cuda.check(rc, "gate_tail")
    gate_tail.launches += 1
    return y


gate_tail.launches = 0
