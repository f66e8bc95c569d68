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

Under autograd :func:`attention` is a ``torch.autograd.Function`` of q, k,
v and the bias table. Its backward is written in PyTorch ops: it
recomputes ``S = (q * scale) k^T + bias`` in the forward's rounding order
and ``P = softmax(S)`` in float32 (one layer's P at a time: BEiT-L's is
~151 MB at batch 4, so none is kept from the forward), then ``dv = P^T dO``,
``dS = P * (dO v^T - rowsum(dO * O))``, ``dq = dS k * scale``, ``dk = dS^T
(q * scale)`` and the table's gradient, ``dS`` summed over the batch and
added into the table rows through the relative-position index (the three
cls entries included).
"""

from __future__ import annotations

import torch

from patchrefinerv2_torch.ops import _cuda
from patchrefinerv2_torch.ops._grad import require_float, wants_grad, wide

__all__ = ["attention", "attention_backward", "attention_plain", "relative_position_bias",
           "relative_position_index"]

# 64: BEiT-L and DINOv2-L; 48: the debug-tiny ``vitt``; 16: the tiny BEiT
# of the small composed check
HEAD_DIMS = (16, 48, 64)


def relative_position_index(grid, device=None) -> torch.Tensor:
    """(S, S) rows of the (num_rel + 3, H) table for a (gh, gw) patch grid
    plus the cls token, S = gh * gw + 1: between two patches (qy - ky + gh -
    1) * (2 gw - 1) + (qx - kx + gw - 1); row 0 (cls query) num_rel, column
    0 num_rel + 1, (0, 0) num_rel + 2 -- the timm relative_position_index."""
    gh, gw = int(grid[0]), int(grid[1])
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    p = torch.arange(gh * gw, device=device)
    y, x = p // gw, p % gw
    idx = torch.empty((gh * gw + 1, gh * gw + 1), dtype=torch.long, device=device)
    idx[1:, 1:] = (y[:, None] - y[None, :] + gh - 1) * (2 * gw - 1) + (x[:, None] - x[None, :] + gw - 1)
    idx[0, :] = num_rel
    idx[:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


def relative_position_bias(table: torch.Tensor, grid) -> torch.Tensor:
    """(H, S, S) BEiT bias (float32; float64 for a float64 table) from the
    (num_rel + 3, H) table, by :func:`relative_position_index`."""
    num_rel = (2 * int(grid[0]) - 1) * (2 * int(grid[1]) - 1)
    if tuple(table.shape[:1]) != (num_rel + 3,):
        raise ValueError(f"expected a ({num_rel + 3}, H) table for grid {grid}, got {tuple(table.shape)}")
    return wide(table)[relative_position_index(grid, table.device)].permute(2, 0, 1)


def _probs(q, k, scale, rel_table, grid):
    """(q * scale, P): q scaled in its dtype and the softmax of the logits,
    in the compute dtype (float32; float64 for float64)."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.matmul(wide(qs), wide(k).transpose(-2, -1))
    if rel_table is not None:
        s = s + relative_position_bias(rel_table, grid)
    return qs, torch.softmax(s, dim=-1)


def attention_plain(q, k, v, scale: float, rel_table=None, grid=None):
    """Plain PyTorch version of :func:`attention` (any device)."""
    _, p = _probs(q, k, scale, rel_table, grid)
    return torch.matmul(wide(p.to(v.dtype)), wide(v)).to(q.dtype)


def attention_backward(do, q, k, v, o, scale: float, rel_table=None, grid=None):
    """(dq, dk, dv, d table or None) of :func:`attention` for the output
    gradient ``do``, from the inputs and the forward's output ``o``, with
    the probabilities recomputed (float32; float64 for float64)."""
    qs, p = _probs(q, k, scale, rel_table, grid)
    do = wide(do)
    dv = torch.matmul(p.transpose(-2, -1), do)
    ds = torch.matmul(do, wide(v).transpose(-2, -1))
    ds -= (do * wide(o)).sum(-1, keepdim=True)
    ds *= p
    del p
    dq = torch.matmul(ds, wide(k)) * scale
    dk = torch.matmul(ds.transpose(-2, -1), wide(qs))
    dt = None
    if rel_table is not None:
        h = rel_table.shape[1]
        idx = relative_position_index(grid, ds.device).reshape(-1)
        dt = torch.zeros((rel_table.shape[0], h), dtype=ds.dtype, device=ds.device)
        dt.index_add_(0, idx, ds.sum(0).reshape(h, -1).t())
        dt = dt.to(rel_table.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dt


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
    if wants_grad(q, k, v, rel_table):
        require_float("attention", q, k, v, rel_table)
        return _Attention.apply(q, k, v, rel_table, scale, grid)
    return _forward(q, k, v, scale, rel_table, grid)


def _forward(q, k, v, scale, rel_table, grid):
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


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_table, scale, grid):
        o = _forward(q, k, v, scale, rel_table, grid)
        ctx.save_for_backward(q, k, v, o, rel_table)
        ctx.scale, ctx.grid = scale, grid
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, rel_table = ctx.saved_tensors
        dq, dk, dv, dt = attention_backward(do, q, k, v, o, ctx.scale, rel_table, ctx.grid)
        return dq, dk, dv, dt, None, None


attention.launches = 0
