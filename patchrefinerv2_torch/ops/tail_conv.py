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
concatenation, and writes ``y`` once. :func:`launch_plan` picks the kernel
and its shapes: bfloat16 runs a persistent warp-specialised ``wgmma``
implicit GEMM fed by a streamed ring of halo and weight k-steps (at Cout <=
8 the ``mma.sync`` kernel), float32 the CUDA-core kernel (the tensor cores
would round float32 to TF32). The weights are laid out once per weight
tensor (:func:`formatted_weight`, re-formatted when the tensor changes).
On a CPU tensor it runs :func:`tail_conv_plain`. ``tail_conv.launches``
counts the kernel launches.

Under autograd :func:`tail_conv` is a ``torch.autograd.Function``
(``_TailConv``): the forward as above, the backward in PyTorch ops: the
epilogue's gradient (the ReLU's from the saved output; the GELU's and the
LayerNorm's from the conv output, recomputed with one ``F.conv2d``), then
``aten.convolution_backward`` for the data and weight gradients of the
concatenated input, split back into its parts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops._grad import ln_backward, ln_stats, require_float, wants_grad, wide

__all__ = ["tail_conv", "tail_conv_plain", "launch_plan", "format_weight", "formatted_weight"]

ACTS = {"none": 0, "relu": 1, "gelu": 2}
MAX_PARTS = 4
CHUNK = 32  # input channels per chunk of the mma route's weight layout
KSTEP = 16  # input channels per k-step of the wgmma route
RUN = 64  # output pixels of an m64 run (a tile row) of the wgmma route
SMEM_MAX = 232448  # shared memory a block can have (bytes)
MAX_STAGES = 8
WGMMA_FIXED = 128 + 128 + 3 * 128 * 4  # alignment, the ring's barriers, the epilogue's parameters
MMA_RESIDENT = 113 * 1024  # the mma route keeps all of its weights when they fit


def cout_pad(cout: int) -> int:
    """The kernels' output-channel tile for ``cout`` (1..128)."""
    return 8 if cout <= 8 else 32 if cout <= 32 else 128


def _up128(b: int) -> int:
    return -(-b // 128) * 128


def launch_plan(widths, k: int, cout: int, dtype) -> dict:
    """The host's plan for one ``tail_conv`` launch, as ``csrc/tail_conv.cu``
    takes it, from the parts' widths, the kernel size, Cout and the dtype.

    Route ``"wgmma"``, bfloat16 with Cout > 8: N = Cout padded to 32 or
    128; ``runs`` m64 runs (tile rows of ``RUN`` pixels) for each of the two
    consumer warpgroups, 2 at N 128 and 4 at N 32, so a tile is ``rows`` = 2
    * runs rows by 64 pixels; a stage is one of the ``nk`` k-steps of 16
    input channels: the tile's halo (``halo``: rows, channel halves of 8,
    columns of 16-byte cells) and the weights of every tap; beside the ring
    each consumer keeps an output tile (``runs`` x 64 pixel rows of N
    bfloat16, padded by 16 bytes) through which the residual comes in and
    the output goes out in 16-byte units; ``stages`` as many as fit beside
    the barriers, the epilogue's parameters and the output tiles, at most 8;
    ``producers`` warpgroups keep the ring full: 1 at N 128 (its
    accumulators need the registers), 2 at N 32 (more cp.asyncs in flight
    for the byte-bound sites).

    Route ``"mma"``, float32 (CUDA-core FMAs: the tensor cores would round
    float32 to TF32) and bfloat16 with Cout <= 8 (``mma.sync``: a wgmma of
    N 8 is bound by its issue, not the tensor cores): tiles of 16 x 16 pixels (8 x
    16 at N 128) by N, a chunk of 32 channels at a time, the weights kept
    whole when they fit (``resident``)."""
    cin, taps = sum(widths), k * k
    n = cout_pad(cout)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tail_conv takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and n > 8:
        runs = 2 if n == 128 else 4
        rows = 2 * runs
        halo = (rows + k - 1, 2, RUN + k - 1)
        a_bytes = halo[0] * halo[1] * halo[2] * 16
        stage = _up128(a_bytes) + 2 * taps * n * 16
        out = 2 * runs * RUN * (2 * n + 16)  # the consumers' output tiles, rows padded by 16 bytes
        stages = min(MAX_STAGES, (SMEM_MAX - WGMMA_FIXED - out) // stage)
        return dict(route="wgmma", n=n, runs=runs, producers=1 if n == 128 else 2, tile=(rows, RUN),
                    halo=halo, nk=-(-cin // KSTEP), stages=stages, stage_bytes=stage, out_bytes=out,
                    smem=WGMMA_FIXED + stages * stage + out)
    bf = dtype == torch.bfloat16
    es = 2 if bf else 4
    th = 8 if n == 128 else 16
    nch = -(-cin // CHUNK)
    wb = _up128(taps * CHUNK * (n + (8 if bf else 0)) * es)
    hb = _up128((th + k - 1) * (16 + k - 1) * (CHUNK + (8 if bf else 1)) * es)
    ob = _up128(th * 16 * (n + 4) * 4)
    resident = wb * nch + max(hb, ob) <= MMA_RESIDENT
    smem = wb * nch + max(hb, ob) if resident else max(wb + hb, ob)
    return dict(route="mma", n=n, runs=0, producers=0, tile=(th, 16), nk=nch, stages=0, smem=smem,
                resident=resident)


def tail_conv_plain(parts, weight, bias=None, residual=None, ln=None, act: str = "none",
                    relu_in: bool = False, eps: float = 1e-6):
    """Plain PyTorch version of :func:`tail_conv` (any device). It rounds
    where the kernel does: every step in float32, one rounding to the
    input dtype at the end."""
    dt = parts[0].dtype
    x = torch.cat([wide(p) for p in parts], dim=-1).permute(0, 3, 1, 2)
    if relu_in:
        x = torch.relu(x)
    k = weight.shape[-1]
    y = F.conv2d(x, wide(weight), padding=k // 2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + wide(bias)
    if residual is not None:
        y = y + wide(residual)
    if ln is not None:
        mean = y.mean(-1, keepdim=True)
        var = torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (y - mean) * (torch.rsqrt(var + eps) * wide(ln[0])) + wide(ln[1])
    if act == "relu":
        y = torch.relu(y)
    elif act == "gelu":
        y = F.gelu(y, approximate="tanh" if dt == torch.bfloat16 else "none")
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y.to(dt)


def format_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, k, k) -> the layout of the kernel that :func:`launch_plan`
    picks for the weight's dtype and Cout, zero-padded past Cin and Cout (N
    = ``cout_pad(Cout)``):

    - route "mma" (float32; bfloat16 with Cout <= 8):
      ``[ceil(Cin / 32)][k * k][32][N]``;
    - route "wgmma" (bfloat16 with Cout > 8): ``[ceil(Cin / 16)][2][k *
      k][N][8]``, for each k-step of 16 channels its two halves, each a
      K-major plane of (tap, output channel) rows of 8 channels (16 bytes):
      one contiguous block a k-step, which the kernel brings in one bulk
      copy, ``wf[s, h, tap, o, i] = weight[o, 16 s + 8 h + i, tap // k, tap
      % k]``."""
    cout, cin, k, _ = weight.shape
    n = cout_pad(cout)
    wgmma = weight.dtype == torch.bfloat16 and n > 8
    step = KSTEP if wgmma else CHUNK
    nch = -(-cin // step)
    w = weight.permute(2, 3, 1, 0).reshape(k * k, cin, cout)
    w = F.pad(w, (0, n - cout, 0, nch * step - cin))  # (taps, Cin_pad, N)
    if not wgmma:
        return w.reshape(k * k, nch, CHUNK, n).transpose(0, 1).contiguous()
    return w.reshape(k * k, nch, 2, 8, n).permute(1, 2, 0, 4, 3).contiguous()


def formatted_weight(weight: torch.Tensor) -> torch.Tensor:
    """:func:`format_weight` of ``weight``, kept on the tensor and made anew
    when its storage or its version counter changes (``load_jax_params``'
    in-place copies, any ``copy_`` or ``data`` assignment), so that a frame
    runs no format pass."""
    key = (weight.data_ptr(), weight._version, weight.dtype, tuple(weight.shape))
    kept = getattr(weight, "_tail_conv_format", None)
    if kept is None or kept[0] != key:
        kept = (key, format_weight(weight.detach()))
        weight._tail_conv_format = kept
    return kept[1]


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
    lw, lb = ln if ln is not None else (None, None)
    if wants_grad(*parts, weight, bias, residual, lw, lb):
        require_float("tail_conv", *parts, weight, bias, residual, lw, lb)
        return _TailConv.apply((act, bool(relu_in), eps), weight, bias, residual, lw, lb,
                               *(p.contiguous() for p in parts))
    return _forward(parts, weight, bias, residual, ln, act, relu_in, eps)


def _forward(parts, weight, bias, residual, ln, act, relu_in, eps):
    n, h, w = parts[0].shape[:3]
    _flops.add("tail_conv", _flops.conv(n, h, w, weight.shape[0], weight.shape[1], weight.shape[-1]))
    if _cuda.on_cpu(parts[0]):
        return _flops.plain(tail_conv_plain, parts, weight, bias, residual, ln, act, relu_in, eps)
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"tail_conv takes 1 to {MAX_PARTS} input parts, got {len(parts)}")
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
    # The weight may have any strides: formatted_weight re-lays it out.
    _cuda.require_cuda(*parts, *extra)
    if weight.device != parts[0].device:
        raise ValueError(f"weight on {weight.device}, parts on {parts[0].device}")
    dt = parts[0].dtype
    if any(t.dtype != dt for t in parts + [weight] + extra):
        raise ValueError("tail_conv takes every tensor in one dtype, got "
                         f"{sorted({str(t.dtype) for t in parts + [weight] + extra})}")
    code = _cuda.dtype_code(dt)
    plan = launch_plan([p.shape[3] for p in parts], k, cout, dt)
    wf = formatted_weight(weight)
    y = torch.empty((n, h, w, cout), dtype=dt, device=parts[0].device)
    ps = parts + [None] * (MAX_PARTS - len(parts))
    cs = [p.shape[3] for p in parts] + [0] * (MAX_PARTS - len(parts))
    lg, lb = ln if ln is not None else (None, None)
    fn = _cuda.bind("tail_conv", "prv2_tail_conv", 10, 15, 1)
    rc = fn(*(_cuda.ptr(p) for p in ps), _cuda.ptr(wf), _cuda.ptr(bias), _cuda.ptr(residual),
            _cuda.ptr(lg), _cuda.ptr(lb), _cuda.ptr(y), n, h, w, *cs, cout, k, int(relu_in),
            ACTS[act], plan["n"], plan["runs"], plan["producers"], plan["stages"], float(eps), code,
            _cuda.stream_of(y))
    _cuda.check(rc, "tail_conv")
    tail_conv.launches += 1
    return y


class _TailConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, weight, bias, residual, ln_w, ln_b, *parts):
        act, relu_in, eps = cfg
        ln = None if ln_w is None else (ln_w, ln_b)
        y = _forward(list(parts), weight, bias, residual, ln, act, relu_in, eps)
        ctx.cfg, ctx.has_bias = cfg, bias is not None
        # the ReLU's mask comes from the output; the GELU and the LayerNorm
        # need the conv output, recomputed in the backward from the inputs
        recompute = ln is not None or act == "gelu"
        ctx.save_for_backward(weight, bias if recompute else None,
                              residual if recompute else None, ln_w, ln_b,
                              y if act == "relu" and ln is None else None, *parts)
        return y

    @staticmethod
    def backward(ctx, gy):
        act, relu_in, eps = ctx.cfg
        weight, bias, residual, ln_w, ln_b, y, *parts = ctx.saved_tensors
        need = ctx.needs_input_grad
        k = weight.shape[-1]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        xin = torch.relu(x) if relu_in else x
        xin_nchw = xin.permute(0, 3, 1, 2)
        g = gy.contiguous()
        dln_w = dln_b = None
        if ln_w is not None or act == "gelu":
            pre = F.conv2d(xin_nchw, weight, bias, padding=k // 2).permute(0, 2, 3, 1)
            if residual is not None:
                pre = pre + residual
            cout = pre.shape[-1]
            rows = pre.reshape(-1, cout)
            z = rows
            if ln_w is not None:
                mean, rstd, _ = ln_stats(rows, eps)
                z = (rows - mean) * (rstd * ln_w) + ln_b
            gz = g.reshape(-1, cout)
            if act == "gelu":
                gz = torch.ops.aten.gelu_backward(gz, z, approximate="none")
            elif act == "relu":
                gz = gz * (z > 0)
            if ln_w is not None:
                gz, dln_w, dln_b = ln_backward(gz, rows, ln_w, eps)
            dpre = gz.reshape(g.shape)
        elif act == "relu":
            dpre = g * (y > 0)
        else:
            dpre = g
        dbias = dpre.sum((0, 1, 2)) if ctx.has_bias and need[2] else None
        dres = dpre if need[3] else None
        want_x = any(need[6:])
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dpre.permute(0, 3, 1, 2), xin_nchw, weight, None, [1, 1], [k // 2, k // 2], [1, 1],
            False, [0, 0], 1, [want_x, need[1], False])
        dparts = [None] * len(parts)
        if want_x:
            dx = dx.permute(0, 2, 3, 1)
            if relu_in:
                dx = dx * (x > 0)
            lo = 0
            for i, p in enumerate(parts):
                if need[6 + i]:
                    dparts[i] = dx[..., lo:lo + p.shape[-1]]
                lo += p.shape[-1]
        return (None, dw, dbias, dres, dln_w, dln_b, *dparts)


tail_conv.launches = 0
