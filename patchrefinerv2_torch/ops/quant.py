"""K10: the int8 SAME convolution,
``y = relu?(f32(conv_int32(q(relu?(cat(parts))), kq)) * scale + bias (+ residual))``
over NHWC maps.

Counterpart of ``patchrefinerv2_tpu/ops/quant.py``: ``quant_conv_same``
(:130, one activation scale, calibrated or taken live), ``quant_conv_same_perchan``
(:154, a scale per input channel, folded into the weights) and both serving
branches of ``conv_dispatch`` (:218), at the plain ``qamax`` sites and at the
space-to-depth ``head`` sites. Every mode is one function here:

1. ``q(x) = clip(round_half_even(f32(x) / sx[c]), -127, 127)`` as int8, with
   ``sx`` a float32 scale per input channel (the per-tensor mode repeats its
   one scale);
2. the int32 sums of a 3x3 (SAME) or 1x1 convolution of ``q`` with the
   int8 weights ``kq`` (Cout, Cin, k, k);
3. ``y = f32(acc) * scale[o]`` (``scale = sx * sw`` formed first in the
   per-tensor mode, ``swc`` in the per-channel mode), then ``+ f32(bias)``,
   rounded to the input dtype;
4. with ``residual``: ``y + residual`` rounded again to the input dtype, as
   the reference's ``quant_conv(...) + x`` rounds it; with ``relu_out`` a
   ReLU last (``relu(dconv(...))`` at the C2F ``qsd`` site).

**Phased** (the head GatedConvUnit's 3x3 convs with per-channel scales):
the reference runs them on space-to-depth maps, whose per-channel scales are
per (pixel phase, channel), ``ph(h, w) = 2 * (h % 2) + (w % 2)`` (the
group-major order of ``ops/s2d.py`` ``space_to_depth``). Folded into the
expanded kernel they give weights and dequant scales by the output pixel's
phase. Here, in the plain layout: ``sx`` (4, Cin), ``kq`` (4, Cout, Cin, 3,
3), ``scale`` (4, Cout), and

    q[n,h,w,c]   = clip(rne(f32(x)[n,h,w,c] / sx[ph(h,w), c]), -127, 127)
    acc[n,h,w,o] = sum_{du,dv,c} q[n,h+du-1,w+dv-1,c] * kq[ph(h,w)][o,c,du,dv]
    y            = rnd(f32(acc) * scale[ph(h,w), o] + f32(bias[o]))

(:func:`fold_phased` folds them). With per-tensor or dynamic scales nothing
depends on the phase, and the head sites are plain K10 calls.

**Dynamic** (``dynamic=True``, no calibration): ``sx`` is the input's live
abs-max (after the ReLU) as :func:`act_scale` makes it, one per call, and
``scale`` holds the weights' per-output-channel scales ``sw``; the
dequantize scale is ``sx * sw``. On the card the abs-max is a reduction
kernel whose result stays on the device.

``relu_in`` applies a ReLU to the inputs first (``GatedConvUnit``'s
``conv(relu(x))``). The quantize helpers below are the reference's
``_quantize_per_tensor``, ``_quantize_per_out_channel`` and
``_fold_act_scales`` in the port's (Cout, Cin, k, k) weight layout.

On a CUDA tensor :func:`quant_conv` launches the kernels of
``csrc/quant_conv.cu`` (or raises): in the dynamic mode the abs-max pass,
then a quantize pass that reads the parts in place and writes an int8
scratch of 16-byte cells (16 channels of one column of a plane of a row; at
a phased site two column-parity planes, so that one output phase's pixels
of a row are contiguous), then the int8 implicit-GEMM convolution on
``wgmma``, its halo and weights fed by TMA through an mbarrier ring, with
the dequantize, bias, residual and ReLU in its epilogue. :func:`launch_plan`
picks its N tiles per site (one or two launches: Cout 322 as 128 + 128 +
80), ring depth and scratch shape; :func:`format_weight` lays the weights
out as the kernel's bulk copies read them. A phased tile has all four
phases of its region computed from one halo.
``quant_conv.launches`` counts the calls that launch them. On a CPU tensor
it runs :func:`quant_conv_plain`, whose int32 sums are exact (a float64
convolution of integers: |acc| <= 127^2 * k^2 * Cin < 2^53).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops._grad import forbid_grad

__all__ = [
    "quant_conv", "quant_conv_plain", "quantize", "act_scale", "quantize_per_out_channel",
    "fold_act_scales", "fold_phased", "pixel_phase", "int8_conv_sums", "site_selected",
    "format_weight", "launch_plan", "n_tiles", "LAYOUTS",
]

MAX_PARTS = 4
CHUNK = 32  # input channels per k-step of the kernel (one wgmma k32 depth, two 16-byte halves)
PHASES = 4  # pixel phases (h % 2, w % 2) of a phased site
# the product kernel's block (csrc/quant_conv.cu): ROWS output rows by runs
# of RUN pixels (the wgmma M), two consumer warpgroups of 2 runs (phased: 4,
# both column phases of 2 rows); its N tiles, the widest first; the shared
# memory a block may take and the ring's deepest
ROWS, RUN = 4, 64
N_TILES = {False: (128, 80, 32, 8), True: (32, 8)}  # an integer wgmma's N: 8, 16, 24, 32, 48, ...
SMEM_MAX = 232448
MAX_STAGES = 4
# where the reference runs a site: the plain layout, a 3x3 SAME conv on a
# space-to-depth map (``s2d``: its kernel expanded to (3, 3, 4Cin, 4Cout)),
# or the stride-2 conv that enters that form from the plain map
# (``s2d_down``: ops/s2d.py conv_down_expanded, kernel (4, 4, Cin, 4Cout))
LAYOUTS = ("plain", "s2d", "s2d_down")


# The reference writes its scales as ``max(amax, 1e-8) / 127.0``; XLA compiles
# a division by a constant to a product with the constant's float32
# reciprocal, and every scale of the reference is computed inside ``jit``, so
# the port takes that product too (a true division differs in the last bit
# for ~4% of the scales). The quantize itself, ``x / sx``, is a true division
# on both sides.
RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` in float32 as the reference computes it:
    the scale of an abs-max (a scalar, one per input channel, or one per
    output channel of a weight)."""
    return torch.clamp(amax.float(), min=1e-8) * RECIP_127.to(amax.device)


def quantize(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round_half_even(f32(x) / sx), -127, 127)`` as int8; ``sx``
    broadcasts over the last (channel) axis."""
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)


def quantize_per_out_channel(w: torch.Tensor):
    """Symmetric int8 per output channel of a (Cout, Cin, k, k) weight:
    (kq int8, sw float32 (Cout,))."""
    wf = w.float()
    sw = act_scale(wf.abs().amax(dim=(1, 2, 3)))
    return quantize(wf, sw[:, None, None, None]), sw


def fold_act_scales(w: torch.Tensor, amax_c: torch.Tensor):
    """The per-input-channel activation scales folded into the weight:
    (f32(w) * sx_c over the Cin axis, sx_c)."""
    sx = act_scale(amax_c)
    return w.float() * sx[None, :, None, None], sx


def fold_phased(w: torch.Tensor, amax_c: torch.Tensor):
    """The per-(pixel phase, channel) activation scales ``amax_c`` (4, Cin)
    folded into a 3x3 weight (Cout, Cin, 3, 3) by output phase, then
    quantized per output channel: (kqc int8 (4, Cout, Cin, 3, 3), swc
    float32 (4, Cout)). Output phase (di, dj) at tap (du, dv) reads the input
    phase ``((di + du - 1) % 2) * 2 + (dj + dv - 1) % 2``, as
    ``s2d_same_kernel`` places the tap (ops/s2d.py:114-136): the same
    numbers as quantizing the reference's folded expanded kernel, whose
    other taps are zeros."""
    sx = act_scale(amax_c)
    kqc, swc = [], []
    for di in range(2):
        for dj in range(2):
            gi = torch.tensor([[((di + du - 1) % 2) * 2 + (dj + dv - 1) % 2 for dv in range(3)]
                               for du in range(3)], device=w.device)
            sx_tap = sx[gi].permute(2, 0, 1)  # (Cin, 3, 3): the scale each tap's input has
            kq, sw = quantize_per_out_channel(w.float() * sx_tap[None])
            kqc.append(kq)
            swc.append(sw)
    return torch.stack(kqc), torch.stack(swc)


def pixel_phase(h: int, w: int, device=None) -> torch.Tensor:
    """``ph(h, w) = 2 * (h % 2) + (w % 2)`` over an (h, w) map, int64."""
    ys = torch.arange(h, device=device) % 2
    xs = torch.arange(w, device=device) % 2
    return ys[:, None] * 2 + xs[None, :]


def site_selected(weight_shape, hw: int, min_kc: int, min_hw: int, layout: str = "plain") -> bool:
    """The reference's serving gate (``quant.py:272-283``): a conv takes the
    int8 path when kh * kw * Cout >= ``min_kc`` and its input has at least
    ``min_hw`` pixels, both counted on the shapes the reference runs: for a
    ``layout`` of ``s2d`` the expanded kernel (kh, kw, 4Cin, 4Cout) on the
    (H/2)(W/2) map, for ``s2d_down`` the (kh+1, kw+1, Cin, 4Cout) kernel on
    the H x W map. ``weight_shape``: the plain (Cout, Cin, kh, kw); ``hw``:
    the plain input's pixels."""
    cout, _, kh, kw = weight_shape
    if layout == "s2d":
        return kh * kw * 4 * cout >= min_kc and hw // 4 >= min_hw
    if layout == "s2d_down":
        return (kh + 1) * (kw + 1) * 4 * cout >= min_kc and hw >= min_hw
    return kh * kw * cout >= min_kc and hw >= min_hw


def int8_conv_sums(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of the SAME convolution of int8 NHWC ``xq`` with
    int8 ``kq`` (Cout, Cin, k, k), as an NHWC int32 map: a float64
    convolution, exact for these integers."""
    k = kq.shape[-1]
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), kq.double(), padding=k // 2)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def quant_conv_plain(parts, kq, sx, scale, bias=None, relu_in: bool = False, residual=None,
                     relu_out: bool = False, dynamic: bool = False):
    """Plain PyTorch version of :func:`quant_conv` (any device). The sums
    are exact; float64 -> float32 rounds them to nearest even, as the
    int32 -> float32 conversion does. A phased call takes each phase's
    sums from its own weights."""
    dt = parts[0].dtype
    x = torch.cat(list(parts), dim=-1)
    if relu_in:
        x = torch.relu(x)
    if dynamic:
        sx = act_scale(x.float().abs().amax())
        sx, scale = sx.expand(x.shape[-1]), sx * scale
    k = kq.shape[-1]
    if kq.ndim == 5:  # phased: scales and weights by pixel phase
        ph = pixel_phase(x.shape[1], x.shape[2], x.device)
        xq = quantize(x, sx[ph]).permute(0, 3, 1, 2).double()
        acc = sum(F.conv2d(xq, kq[g].double(), padding=k // 2) * (ph == g) for g in range(PHASES))
        y = acc.permute(0, 2, 3, 1).float() * scale[ph]
    else:
        xq = quantize(x, sx).permute(0, 3, 1, 2).double()
        acc = F.conv2d(xq, kq.double(), padding=k // 2).permute(0, 2, 3, 1)
        y = acc.float() * scale
    if bias is not None:
        y = y + bias.float()
    y = y.to(dt)
    if residual is not None:
        y = (y.float() + residual.float()).to(dt)
    if relu_out:
        y = torch.relu(y)
    return y


def n_tiles(cout: int, phased: bool) -> list:
    """The widths of the kernel's N tiles over ``cout`` output channels, in
    order: as many of the widest as fit, then the narrowest that holds the
    rest (Cout 322: 128, 128, 80; the flagship head's 32: 32)."""
    tiles = N_TILES[phased]
    full, rem = divmod(cout, tiles[0])
    return [tiles[0]] * full + ([min(t for t in tiles if t >= rem)] if rem else [])


def format_weight(kq: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, k, k) int8 -> the kernel's weights, flat: for each N tile
    of :func:`n_tiles` in turn ``[Cin / 32][1][2][k * k][N][16]``, for each
    32-channel k-step its two 16-channel halves, each a K-major plane of
    (tap, output channel) rows of 16 bytes, zero past Cin and Cout; a
    phased (4, Cout, Cin, 3, 3) -> ``[Cin / 32][4][2][9][N][16]`` a tile,
    the four phases of a k-step together. A tile's k-step is one contiguous
    block that the kernel copies in one bulk load: tile t (first channel
    o_t) starts at ``o_t * Cin_pad * phases * k * k`` bytes, and
    ``wf[start + ((((s * phases + ph) * 2 + h) * k * k + tap) * N + o) * 16 + i]
    = kq[ph][o_t + o, 32 s + 16 h + i, tap // k, tap % k]``."""
    qs = kq if kq.ndim == 5 else kq[None]
    ph, cout, cin, k, _ = qs.shape
    nch = -(-cin // CHUNK)
    widths = n_tiles(cout, kq.ndim == 5)
    w = torch.zeros((ph, k * k, sum(widths), nch * CHUNK), dtype=torch.int8, device=kq.device)
    w[:, :, :cout, :cin] = qs.permute(0, 3, 4, 1, 2).reshape(ph, k * k, cout, cin)
    out, o = [], 0
    for nt in widths:
        t = w[:, :, o:o + nt].reshape(ph, k * k, nt, nch, 2, CHUNK // 2)
        out.append(t.permute(3, 0, 4, 1, 2, 5).reshape(-1))
        o += nt
    return torch.cat(out).contiguous()


def launch_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, phased: bool,
                itemsize: int = 2) -> dict:
    """The host's plan for one product launch, as ``csrc/quant_conv.cu``
    takes it: the N tiles (up to two segments, ``(N, tiles, stages)``, the
    second from channel N * tiles of the first), each segment's ring depth
    and shared memory, and the int8 scratch's shape. A tile is ``ROWS``
    rows by ``RUN`` pixels (phased: by ``RUN`` pixels of each column phase,
    from one halo over the two column-parity planes) by N channels; a
    persistent block per SM walks a segment's ``tiles`` (pixel tiles x N
    tiles). A stage holds the halo of one k-step (``halo``: rows, channel
    halves, planes, columns) and the N tile's weights for every tap (and
    phase); beside the ring each consumer keeps its output tiles (RUN rows
    of N outputs of ``itemsize`` bytes a run, bfloat16 rows padded by 8
    elements)."""
    planes, phases, taps = (2, 4, 9) if phased else (1, 1, k * k)
    runs = 4 if phased else 2
    halo = (ROWS + k - 1, 2, planes, RUN + k - 1)
    cols = -(-w // 2) if phased else w  # the columns of a plane of the scratch
    nch = -(-cin // CHUNK)
    a_box = halo[0] * halo[1] * halo[2] * halo[3] * 16
    pixel_tiles = n * -(-h // ROWS) * -(-cols // RUN)
    widths = n_tiles(cout, phased)
    segments = []
    for nt in dict.fromkeys(widths):
        count = widths.count(nt)
        stage = -(-a_box // 128) * 128 + phases * 2 * taps * nt * 16
        out = 2 * runs * RUN * (nt * itemsize + (16 if itemsize == 2 else 0))
        fixed = 384 + out  # the base's alignment, the barriers, the output tiles
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // stage)
        segments.append(dict(n=nt, tiles=count, stages=stages, stage_bytes=stage, out_bytes=out,
                             smem=fixed + stages * stage, work=pixel_tiles * count,
                             tx_bytes=a_box + phases * 2 * taps * nt * 16))
    return dict(segments=segments, halo=halo, phases=phases, taps=taps, nchunk=nch, runs=runs,
                pixel_tiles=pixel_tiles, xq_shape=(n, h, 2 * nch, planes, cols, CHUNK // 2))


def quant_conv(parts, kq: torch.Tensor, sx: torch.Tensor | None, scale: torch.Tensor,
               bias: torch.Tensor | None = None, relu_in: bool = False,
               residual: torch.Tensor | None = None, wf: torch.Tensor | None = None,
               relu_out: bool = False, dynamic: bool = False) -> torch.Tensor:
    """``parts``: 1-4 NHWC maps (N, H, W, C_i) of one size and dtype (float32
    or bfloat16), concatenated along channels in this order; ``kq``: int8
    (Cout, sum C_i, k, k) with k 3 (SAME) or 1, or a phased (4, Cout, sum C_i,
    3, 3); ``sx``: float32 (sum C_i,) activation scales ((4, sum C_i) when
    phased; None when ``dynamic``); ``scale``: float32 (Cout,) dequantize
    scales ((4, Cout) when phased; the weights' ``sw`` when ``dynamic``);
    ``bias``: (Cout,) in the input dtype or None; ``residual``: (N, H, W,
    Cout) or None; ``wf``: ``format_weight(kq)`` when the caller keeps it.
    Returns (N, H, W, Cout) in the input dtype."""
    parts = list(parts)
    forbid_grad("quant_conv", *parts, residual)
    n, h, w = parts[0].shape[:3]
    _flops.add("quant_conv", _flops.conv(n, h, w, kq.shape[-4], sum(p.shape[3] for p in parts),
                                         kq.shape[-1]))
    if _cuda.on_cpu(parts[0]):
        return _flops.plain(quant_conv_plain, parts, kq, sx, scale, bias, relu_in, residual,
                            relu_out, dynamic)
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"quant_conv takes 1 to {MAX_PARTS} input parts, got {len(parts)}")
    if any(p.ndim != 4 or tuple(p.shape[:3]) != (n, h, w) for p in parts):
        raise ValueError(f"quant_conv parts must be NHWC maps of one size, got "
                         f"{[tuple(p.shape) for p in parts]}")
    cin = sum(p.shape[3] for p in parts)
    phased = kq.ndim == 5
    lead = (PHASES,) if phased else ()
    cout, k = kq.shape[-4], kq.shape[-1]
    if (kq.dtype != torch.int8 or tuple(kq.shape) != (*lead, cout, cin, k, k) or k not in (1, 3)
            or (phased and (k != 3 or dynamic))):
        raise ValueError(f"quant_conv takes an int8 (Cout, {cin}, k, k) weight with k 1 or 3, or a "
                         f"phased (4, Cout, {cin}, 3, 3) one outside the dynamic mode, got "
                         f"{kq.dtype} {tuple(kq.shape)}")
    if relu_out and (phased or k != 3):
        raise ValueError("the kernel takes relu_out with a plain 3x3 weight only (the qsd site)")
    if dynamic:
        if sx is not None:
            raise ValueError("the dynamic mode takes no activation scales: sx must be None")
    elif sx is None or sx.dtype != torch.float32 or tuple(sx.shape) != (*lead, cin):
        raise ValueError(f"sx must be float32 {(*lead, cin)}, got "
                         f"{None if sx is None else (sx.dtype, tuple(sx.shape))}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (*lead, cout):
        raise ValueError(f"scale must be float32 {(*lead, cout)}, got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (n, h, w, cout):
        raise ValueError(f"residual {tuple(residual.shape)} is not ({n}, {h}, {w}, {cout})")
    if wf is None:
        wf = format_weight(kq)
    nch = -(-cin // CHUNK)
    wlen = nch * CHUNK * (PHASES if phased else 1) * k * k * sum(n_tiles(cout, phased))
    if tuple(wf.shape) != (wlen,) or wf.dtype != torch.int8:
        raise ValueError(f"formatted weight {tuple(wf.shape)} {wf.dtype} is not ({wlen},) int8")
    dt = parts[0].dtype
    extra = [t for t in (bias, residual) if t is not None]
    # require_cuda checks one device and the dense NHWC layout the kernels
    # assume; it raises, it never copies
    _cuda.require_cuda(*parts, *extra, *([] if dynamic else [sx]), scale, wf)
    if any(t.dtype != dt for t in parts + extra):
        raise ValueError("quant_conv takes the parts, bias and residual in one dtype, got "
                         f"{sorted({str(t.dtype) for t in parts + extra})}")
    code = _cuda.dtype_code(dt)
    dev = parts[0].device
    plan = launch_plan(n, h, w, cin, cout, k, phased, parts[0].element_size())
    segs = [(sg["n"], sg["tiles"], sg["stages"]) for sg in plan["segments"]] + [(0, 0, 0)]
    xq = torch.empty(plan["xq_shape"], dtype=torch.int8, device=dev)
    y = torch.empty((n, h, w, cout), dtype=dt, device=dev)
    sw = amax = None
    if dynamic:  # scratch the kernels fill on the device: the abs-max, sx, sx * sw (16-byte aligned)
        c4 = -(-cin // 4) * 4
        dyn = torch.empty(4 + c4 + cout, dtype=torch.float32, device=dev)
        sw, amax, sx, scale = scale, dyn[:1], dyn[4:4 + cin], dyn[4 + c4:]
    ps = parts + [None] * (MAX_PARTS - len(parts))
    cs = [p.shape[3] for p in parts] + [0] * (MAX_PARTS - len(parts))
    fn = _cuda.bind("quant_conv", "prv2_quant_conv", 13, 18)
    rc = fn(*(_cuda.ptr(p) for p in ps), _cuda.ptr(sx), _cuda.ptr(wf), _cuda.ptr(scale),
            _cuda.ptr(bias), _cuda.ptr(residual), _cuda.ptr(xq), _cuda.ptr(y), _cuda.ptr(sw),
            _cuda.ptr(amax), n, h, w, *cs, cout, k, int(relu_in), int(relu_out), int(phased),
            *segs[0], *segs[1], code, _cuda.stream_of(y))
    _cuda.check(rc, "quant_conv")
    quant_conv.launches += 1
    return y


quant_conv.launches = 0
