"""K3 + K4: exact softmax attention, with the BEiT relative-position bias
or without a bias.

Counterpart of ``patchrefinerv2_tpu/models/backbones/beit.py``
(``relative_position_bias`` :46, ``BeitAttention`` :104, the bias added to
the logits at :141-151) and ``patchrefinerv2_tpu/ops/attention.py``
(``mha`` :44, ``mha_reference`` :27, the bias-free DINOv2 form). Layout
(B, H, S, D) at the public functions. Numerics: ``q * scale`` rounded in
the input dtype, Q.K^T accumulated in float32, the bias added in float32,
a float32 softmax, P rounded to V's dtype, P.V accumulated in float32 and
the output rounded to the input dtype.

On a CUDA tensor :func:`attention` launches a kernel of
``csrc/attention.cu`` (or raises), which computes every bias entry from
the (num_rel + 3, H) table and the timm index formula inside the kernel:
no (H, S, S) bias is written. bfloat16 runs the register-tiled two-pass
kernel on the tensor cores (P normalised in float32 before it is rounded,
any S); float32 runs the three-phase CUDA-core kernel, which keeps a row
of S float32 logits per query in shared memory, so an S whose row does not
fit the card's 227 KB per block (S above ~1500) fails at launch with the
CUDA error of the shared-memory request. q, k and v may be strided views
(the heads of one packed qkv projection); the output is a (B, H, S, D)
view of a (B, S, H, D) buffer, so merging the heads back is free. On a CPU
tensor it runs :func:`attention_plain`. ``attention.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops import _cuda
from patchrefinerv2_torch.ops._grad import forbid_grad

__all__ = ["attention", "attention_plain", "relative_position_bias"]

# 64: BEiT-L and DINOv2-L; 48: the debug-tiny ``vitt``; 16: the tiny BEiT
# of the small composed check
HEAD_DIMS = (16, 48, 64)


def relative_position_bias(table: torch.Tensor, grid) -> torch.Tensor:
    """(H, S, S) float32 BEiT bias for a (gh, gw) patch grid plus the cls
    token, S = gh * gw + 1, from the (num_rel + 3, H) table: between two
    patches index (qy - ky + gh - 1) * (2 gw - 1) + (qx - kx + gw - 1);
    row 0 (cls query) num_rel, column 0 num_rel + 1, (0, 0) num_rel + 2 --
    the timm relative_position_index."""
    gh, gw = int(grid[0]), int(grid[1])
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    if tuple(table.shape[:1]) != (num_rel + 3,):
        raise ValueError(f"expected a ({num_rel + 3}, H) table for grid {grid}, got {tuple(table.shape)}")
    p = torch.arange(gh * gw, device=table.device)
    y, x = p // gw, p % gw
    idx = torch.empty((gh * gw + 1, gh * gw + 1), dtype=torch.long, device=table.device)
    idx[1:, 1:] = (y[:, None] - y[None, :] + gh - 1) * (2 * gw - 1) + (x[:, None] - x[None, :] + gw - 1)
    idx[0, :] = num_rel
    idx[:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return table.float()[idx].permute(2, 0, 1)


def attention_plain(q, k, v, scale: float, rel_table=None, grid=None):
    """Plain PyTorch version of :func:`attention` (any device)."""
    s = torch.matmul((q * torch.tensor(scale, dtype=q.dtype)).float(), k.float().transpose(-2, -1))
    if rel_table is not None:
        s = s + relative_position_bias(rel_table, grid)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _rows_aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


def _check(q, k, v, rel_table, grid):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (B, H, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        if t.device != q.device or t.device.type != "cuda" or t.dtype != q.dtype:
            raise ValueError("expected q, k, v on one CUDA device in one dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"expected unit stride over the head dim, got strides {t.stride()}")
    if rel_table is not None:
        gh, gw = int(grid[0]), int(grid[1])
        if s != gh * gw + 1:
            raise ValueError(f"grid {grid} gives {gh * gw + 1} tokens, q has {s}")
        if tuple(rel_table.shape) != ((2 * gh - 1) * (2 * gw - 1) + 3, h):
            raise ValueError(f"bad relative-position table shape {tuple(rel_table.shape)}")
        if rel_table.dtype != q.dtype or rel_table.device != q.device or not rel_table.is_contiguous():
            raise ValueError("the relative-position table must be contiguous, on q's device, in q's dtype")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              rel_table: torch.Tensor | None = None, grid=None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v for (B, H, S, D) q, k, v. With
    ``rel_table`` ((num_rel + 3, H)) and ``grid`` ((gh, gw), S = gh*gw + 1)
    the BEiT relative-position bias is added; without, no bias."""
    forbid_grad("attention", q, k, v, rel_table)
    if _cuda.on_cpu(q):
        return attention_plain(q, k, v, scale, rel_table, grid)
    _check(q, k, v, rel_table, grid)
    dt = _cuda.dtype_code(q.dtype)
    if q.dtype == torch.bfloat16:  # the kernel loads bf16 Q / K / V rows 16 bytes at a time
        q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    b, h, s, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    gh, gw = (int(grid[0]), int(grid[1])) if rel_table is not None else (0, 0)
    fn = _cuda.bind("attention", "prv2_attention", 5, 18, 1)
    rc = fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), _cuda.ptr(rel_table),
            b, h, s, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            gh, gw, float(scale), dt, _cuda.stream_of(q))
    _cuda.check(rc, "attention")
    attention.launches += 1
    return o


attention.launches = 0
