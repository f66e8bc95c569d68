"""K9: the fusion head's full-resolution low-channel convolutions (the tail),
``y = act(LN(conv_k(relu?(cat(parts))) + bias + residual))`` over NHWC maps.

Counterpart of ``patchrefinerv2_tpu/ops/s2d.py``: ``s2d_same_kernel`` (:114,
with ``split`` over the parts of a concatenation), ``s2d_down_kernel`` /
``conv_s2d_down`` (:139, :190, the segment's entry conv), ``s2d_1x1_kernel``
(:156) and ``layer_norm_s2d`` (:198). The JAX package runs these sites in
space-to-depth form, an exact re-layout that fills the TPU's lanes; the
function it computes is a 3x3 SAME (or 1x1) convolution of the channel
concatenation of a few parts, followed by the epilogues this wrapper fuses:

1. ``bias`` (Cout,);
2. ``residual``, an (N, H, W, Cout) map added to the sum (the
   ``GatedConvUnit`` ``+ x``, and ``final_conv``'s ``update_base``);
3. ``ln=(scale, bias)``: a LayerNorm over the Cout channels of each pixel
   (eps, fast variance ``max(E[x^2] - mean^2, 0)``, float32 statistics, as
   K6);
4. ``act``: ``"none"``, ``"relu"`` (which also gives ``final_conv``'s
   ``clamp(update_base + offset, 0)``) or ``"gelu"`` (tanh form in bfloat16,
   erf form in float32, as ``models/blocks/convs.gelu``).

``relu_in`` applies a ReLU to the inputs first (``GatedConvUnit``'s
``conv(relu(x))``). Every step runs in float32 and the result is rounded
once, to the input dtype.

On a CUDA tensor :func:`tail_conv` launches the kernel of
``csrc/tail_conv.cu`` (or raises): it reads the parts in place, without a
concatenation, and writes ``y`` once. On a CPU tensor it runs
:func:`tail_conv_plain`. ``tail_conv.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops import _cuda

__all__ = ["tail_conv", "tail_conv_plain"]

ACTS = {"none": 0, "relu": 1, "gelu": 2}
MAX_PARTS = 4
CHUNK = 32  # input channels per chunk of the kernel's weight layout (KC)


def cout_pad(cout: int) -> int:
    """The kernel's output-channel tile for ``cout`` (1..128)."""
    return 8 if cout <= 8 else 32 if cout <= 32 else 128


def tail_conv_plain(parts, weight, bias=None, residual=None, ln=None, act: str = "none",
                    relu_in: bool = False, eps: float = 1e-6):
    """Plain PyTorch version of :func:`tail_conv` (any device). It rounds
    where the kernel does: every step in float32, one rounding to the
    input dtype at the end."""
    dt = parts[0].dtype
    x = torch.cat([p.float() for p in parts], dim=-1).permute(0, 3, 1, 2)
    if relu_in:
        x = torch.relu(x)
    k = weight.shape[-1]
    y = F.conv2d(x, weight.float(), padding=k // 2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if ln is not None:
        mean = y.mean(-1, keepdim=True)
        var = torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (y - mean) * (torch.rsqrt(var + eps) * ln[0].float()) + ln[1].float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "gelu":
        y = F.gelu(y, approximate="tanh" if dt == torch.bfloat16 else "none")
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y.to(dt)


def format_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, k, k) -> the kernel's [Cin chunks][k * k][32][Cout_pad],
    zero-padded in both channel axes."""
    cout, cin, k, _ = weight.shape
    nch = -(-cin // CHUNK)
    w = weight.permute(2, 3, 1, 0).reshape(k * k, cin, cout)
    w = F.pad(w, (0, cout_pad(cout) - cout, 0, nch * CHUNK - cin))
    return w.reshape(k * k, nch, CHUNK, -1).transpose(0, 1).contiguous()


def tail_conv(parts, weight: torch.Tensor, bias: torch.Tensor | None = None,
              residual: torch.Tensor | None = None, ln=None, act: str = "none",
              relu_in: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """``parts``: 1-4 NHWC maps (N, H, W, C_i) of one size and dtype,
    concatenated along channels in this order; ``weight``: (Cout, sum C_i,
    k, k) with k 3 (SAME) or 1 and Cout <= 128; ``bias``: (Cout,) or None;
    ``residual``: (N, H, W, Cout) or None; ``ln``: (scale, bias) of the
    channel LayerNorm or None; ``act``: "none", "relu" or "gelu". Returns
    (N, H, W, Cout)."""
    parts = list(parts)
    if _cuda.on_cpu(parts[0]):
        return tail_conv_plain(parts, weight, bias, residual, ln, act, relu_in, eps)
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"tail_conv takes 1 to {MAX_PARTS} input parts, got {len(parts)}")
    n, h, w = parts[0].shape[:3]
    if any(p.ndim != 4 or tuple(p.shape[:3]) != (n, h, w) for p in parts):
        raise ValueError(f"tail_conv parts must be NHWC maps of one size, got "
                         f"{[tuple(p.shape) for p in parts]}")
    cout, cin, k = weight.shape[0], sum(p.shape[3] for p in parts), weight.shape[-1]
    if tuple(weight.shape) != (cout, cin, k, k) or k not in (1, 3) or not 1 <= cout <= 128:
        raise ValueError(f"tail_conv takes a (Cout <= 128, {cin}, k, k) weight with k 1 or 3, "
                         f"got {tuple(weight.shape)}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    vecs = [v for v in (bias,) + (tuple(ln) if ln is not None else ()) if v is not None]
    if any(tuple(v.shape) != (cout,) for v in vecs):
        raise ValueError(f"bias and LayerNorm parameters must be ({cout},), got "
                         f"{[tuple(v.shape) for v in vecs]}")
    if residual is not None and tuple(residual.shape) != (n, h, w, cout):
        raise ValueError(f"residual {tuple(residual.shape)} is not ({n}, {h}, {w}, {cout})")
    extra = vecs + ([residual] if residual is not None else [])
    # require_cuda checks one device and the dense NHWC layout the kernel
    # assumes (is_contiguous on the NHWC view); it raises, it never copies.
    # The weight may have any strides: format_weight re-lays it out.
    _cuda.require_cuda(*parts, *extra)
    if weight.device != parts[0].device:
        raise ValueError(f"weight on {weight.device}, parts on {parts[0].device}")
    dt = parts[0].dtype
    if any(t.dtype != dt for t in parts + [weight] + extra):
        raise ValueError("tail_conv takes every tensor in one dtype, got "
                         f"{sorted({str(t.dtype) for t in parts + [weight] + extra})}")
    code = _cuda.dtype_code(dt)
    wf = format_weight(weight)
    y = torch.empty((n, h, w, cout), dtype=dt, device=parts[0].device)
    ps = parts + [None] * (MAX_PARTS - len(parts))
    cs = [p.shape[3] for p in parts] + [0] * (MAX_PARTS - len(parts))
    lg, lb = ln if ln is not None else (None, None)
    fn = _cuda.bind("tail_conv", "prv2_tail_conv", 10, 11, 1)
    rc = fn(*(_cuda.ptr(p) for p in ps), _cuda.ptr(wf), _cuda.ptr(bias), _cuda.ptr(residual),
            _cuda.ptr(lg), _cuda.ptr(lb), _cuda.ptr(y), n, h, w, *cs, cout, k, int(relu_in),
            ACTS[act], float(eps), code, _cuda.stream_of(y))
    _cuda.check(rc, "tail_conv")
    tail_conv.launches += 1
    return y


tail_conv.launches = 0
