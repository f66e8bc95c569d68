"""The int8 serving mode: which convolutions are int8 sites, how
calibration observes them and how serving routes them to K10
(``ops/quant.py``), with calibrated scales or dynamic ones.

Counterpart of the JAX package's ``conv_dispatch`` (``ops/quant.py:218``)
and ``PatchRefinerPlus.calibrate_int8`` (``models/patchrefinerplus.py:770``).
A block marks each convolution that the reference routes through its
dispatcher with :func:`mark_site`, under the reference's site name
(``qamax_<i>`` or ``qsd_<i>``, numbered in call order within the JAX
module) and the layout the reference runs it in (``ops/quant.LAYOUTS``).
The model switches a marked convolution's ``int8`` attribute between
``None`` (the exact convolution), a :class:`Recorder` (calibration: observe
the input, then run exact) and a :class:`Served` site (the int8 convolution
where the gate selects it, with calibrated per-channel or per-tensor scales,
or dynamic ones). The state lives on the modules: there is no environment
switch and no state at module level.

The sites are those of the reference's default int8 mode, whose default
skip list is ``tailfuse,taildc`` (``quant.py:215``): at the flagship's and
DA2's patch shapes the default gates select 15, the 12 plain-layout ones and
the three ``head`` sites that the reference runs in space-to-depth form.
These are the C2F ``output_conv2`` (``qsd_0``, ``s2d_down``: a plain 3x3
conv here, with a ReLU after it) and the head GatedConvUnit's ``conv``
(``qamax_0``) and ``fusion_conv[0]`` (``qamax_1``), both ``s2d``. The gate
counts their shapes as the reference does (``site_selected``), and at the
``s2d`` sites the per-channel scales are per (pixel phase, channel), as the
reference's per-channel scales of a space-to-depth map are. The
GatedConvUnits' 1x1 inside K5 (``qamax_2``) is marked ``unported``: it
raises if the gate ever selects it. ``tailfuse`` and ``taildc`` (the other
K9 sites) are not marked. At an odd H or W the reference runs the head in
the plain layout, under other site names; the port then runs a head site
exact where the plain gate leaves it exact (always, at the default gates),
and raises ``NotImplementedError`` where it would select it, and in
calibration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn as nn

from patchrefinerv2_torch.ops.quant import (
    LAYOUTS, act_scale, fold_act_scales, fold_phased, format_weight, quant_conv,
    quantize_per_out_channel, site_selected,
)

__all__ = ["Int8Calibration", "Recorder", "Served", "Unported", "int8_conv", "mark_site", "sites_of",
           "record", "calibration", "serve", "SCALES"]

SCALES = ("perchan", "tensor", "dynamic")
MIN_KC, MIN_HW = 1152, 8192  # the reference's default gates (quant.py:272-273)


def mark_site(conv: nn.Conv2d, name: str, unported: bool = False, layout: str = "plain") -> None:
    """Make ``conv`` an int8 site named ``name`` in its JAX module, which the
    reference runs in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    conv.int8_site, conv.int8_unported, conv.int8_layout, conv.int8 = name, unported, layout, None


def sites_of(net: nn.Module) -> dict[str, nn.Conv2d]:
    """The marked convolutions of ``net`` by module name, in module order."""
    return {n: m for n, m in net.named_modules() if hasattr(m, "int8_site")}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def int8_conv(conv: nn.Conv2d, parts, relu_in: bool = False, residual=None, relu_out: bool = False):
    """The int8 output of ``conv`` over the channel concatenation of the NCHW
    ``parts`` (ReLU first with ``relu_in``; ``+ residual`` after, then a ReLU
    with ``relu_out``) at a served site the gate selects, as NCHW; else None,
    and the caller runs the exact convolution. A calibrating site records the
    input first."""
    site = getattr(conv, "int8", None)
    return None if site is None else site(conv, parts, relu_in, residual, relu_out)


def _odd(conv: nn.Conv2d, parts) -> bool:
    """True where the reference would run this head site in the plain layout
    (an odd H or W, ``blocks/dpt.py:365``)."""
    h, w = parts[0].shape[2:]
    return conv.int8_layout != "plain" and (h % 2 == 1 or w % 2 == 1)


def _selected(conv: nn.Conv2d, parts, min_kc: int, min_hw: int) -> bool:
    """The gate at this call. At an odd size a head site follows the
    reference's plain head where the gate leaves it exact, and raises where
    the gate would select it (under a plain site name the port does not
    serve)."""
    h, w = parts[0].shape[2:]
    if _odd(conv, parts):
        if site_selected(conv.weight.shape, h * w, min_kc, min_hw):
            raise NotImplementedError(
                f"the int8 gate selects the head site {conv.int8_site} on an odd {h}x{w} map, where "
                "the reference runs the plain head under other site names: not ported")
        return False
    return site_selected(conv.weight.shape, h * w, min_kc, min_hw, conv.int8_layout)


class Recorder:
    """Calibration at one site: the running abs-max of its input, per tensor
    and per input channel (``quant.py:286-298``) or, at an ``s2d`` site, per
    (pixel phase, input channel) (4, Cin), and its input's pixels."""

    def __init__(self):
        self.amax_c, self.hw = None, None

    def __call__(self, conv, parts, relu_in, residual, relu_out):
        if _odd(conv, parts):
            raise NotImplementedError(
                f"int8 calibration of the head site {conv.int8_site} on an odd "
                f"{tuple(parts[0].shape[2:])} map: the reference calibrates the plain head there, "
                "under other site names")
        mags = [p.clamp(min=0) if relu_in else p.abs() for p in parts]
        if conv.int8_layout == "s2d":
            cur = torch.stack([torch.cat([m[:, :, di::2, dj::2].amax(dim=(0, 2, 3)) for m in mags])
                               for di in range(2) for dj in range(2)]).float()
        else:
            cur = torch.cat([m.amax(dim=(0, 2, 3)) for m in mags]).float()
        self.amax_c = cur if self.amax_c is None else torch.maximum(self.amax_c, cur)
        self.hw = parts[0].shape[2] * parts[0].shape[3]
        return None


class Unported:
    """A site the port does not serve (the GatedConvUnit's 1x1 inside K5):
    exact below the gate, ``NotImplementedError`` where the gate selects it."""

    def __init__(self, name: str, min_kc: int, min_hw: int):
        self.name, self.min_kc, self.min_hw = name, min_kc, min_hw

    def __call__(self, conv, parts, relu_in, residual, relu_out):
        if _selected(conv, parts, self.min_kc, self.min_hw):
            raise NotImplementedError(
                f"the int8 gate selects {self.name}, the GatedConvUnit's 1x1 inside K5, "
                "which the port does not quantize")
        return None


class Served:
    """One site in one scale mode: the int8 weights (and their kernel layout
    on the card), the activation scale per input channel (per pixel phase
    too at an ``s2d`` site with per-channel scales; taken live in the
    dynamic mode) and the dequantize scale per output channel (the weights'
    ``sw`` in the dynamic mode)."""

    def __init__(self, entry: dict, scales: str, min_kc: int, min_hw: int):
        self.dynamic = scales == "dynamic"
        if scales == "perchan":
            if entry.get("kqc") is None:
                raise ValueError("per-channel serving needs the folded weights kqc / swc")
            self.sx, self.kq, self.scale = act_scale(entry["amax_c"]), entry["kqc"], entry["swc"]
        elif self.dynamic:
            self.sx, self.kq, self.scale = None, entry["kq"], entry["sw"]
        else:
            sx = act_scale(entry["amax"])
            self.sx = sx.expand(entry["kq"].shape[1]).contiguous()
            self.kq, self.scale = entry["kq"], (sx * entry["sw"]).contiguous()
        self.wf = format_weight(self.kq) if self.kq.device.type == "cuda" else None
        self.min_kc, self.min_hw = min_kc, min_hw

    def __call__(self, conv, parts, relu_in, residual, relu_out):
        if not _selected(conv, parts, self.min_kc, self.min_hw):
            return None
        y = quant_conv([_nhwc(p) for p in parts], self.kq, self.sx, self.scale, conv.bias, relu_in,
                       None if residual is None else _nhwc(residual), wf=self.wf, relu_out=relu_out,
                       dynamic=self.dynamic)
        return y.permute(0, 3, 1, 2)


@dataclass
class Int8Calibration:
    """The outcome of ``PatchRefinerPlus.calibrate_int8`` (or of
    ``utils/jax_weights.load_jax_int8``): per site (the port's module name),
    ``amax`` (float32 scalar), ``amax_c`` (float32 (Cin,), or (4, Cin) by
    pixel phase at an ``s2d`` site), ``kq`` / ``sw`` (int8 (Cout, Cin, k, k)
    and float32 (Cout,): the weights in the serving dtype, quantized per
    output channel) and ``kqc`` / ``swc`` (the same for the weights with the
    per-channel activation scales folded in; (4, Cout, Cin, 3, 3) and (4,
    Cout) by output phase at an ``s2d`` site), ``hw``, the pixels of the
    site's input when calibration saw it (None otherwise), and ``layout``;
    the dtype the weights were in, and the gates."""

    sites: dict[str, dict] = field(default_factory=dict)
    dtype: torch.dtype = torch.float32
    min_kc: int = MIN_KC
    min_hw: int = MIN_HW

    def to(self, device) -> "Int8Calibration":
        """The same calibration with its tensors on ``device``."""
        sites = {n: {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in e.items()}
                 for n, e in self.sites.items()}
        return Int8Calibration(sites, self.dtype, self.min_kc, self.min_hw)

    def selected(self) -> list[str]:
        """The sites whose calibrated input the gates select."""
        return [n for n, e in self.sites.items()
                if e.get("hw") is not None
                and site_selected(e["kq"].shape, e["hw"], self.min_kc, self.min_hw, e["layout"])]

    @staticmethod
    @torch.no_grad()
    def entry(weight: torch.Tensor, amax_c: torch.Tensor, hw=None, layout: str = "plain") -> dict:
        """One site's entry from its weight (in the serving dtype) and its
        input's per-channel abs-max ((4, Cin) by pixel phase at an ``s2d``
        site)."""
        kq, sw = quantize_per_out_channel(weight)
        if layout == "s2d":
            kqc, swc = fold_phased(weight, amax_c)
        else:
            kqc, swc = quantize_per_out_channel(fold_act_scales(weight, amax_c)[0])
        return dict(amax=amax_c.max(), amax_c=amax_c, kq=kq, sw=sw, kqc=kqc, swc=swc, hw=hw,
                    layout=layout)


def record(net: nn.Module) -> dict[str, Recorder]:
    """Put every site of ``net`` in calibration (the unported ones exact):
    the recorders by site."""
    recs = {}
    for n, conv in sites_of(net).items():
        conv.int8 = None if conv.int8_unported else recs.setdefault(n, Recorder())
    return recs


@torch.no_grad()
def calibration(net: nn.Module, recs: dict[str, Recorder], min_kc: int = MIN_KC,
                min_hw: int = MIN_HW) -> Int8Calibration:
    """The calibration of the sites whose recorders saw an input, with the
    weights of ``net`` as they are (the serving dtype)."""
    sites = sites_of(net)
    cal = Int8Calibration(dtype=next(net.parameters()).dtype, min_kc=min_kc, min_hw=min_hw)
    for n, r in recs.items():
        if r.amax_c is not None:
            cal.sites[n] = Int8Calibration.entry(sites[n].weight, r.amax_c, r.hw,
                                                 sites[n].int8_layout)
    return cal


@torch.no_grad()
def serve(net: nn.Module, cal: Int8Calibration | None, scales: str = "perchan",
          min_kc: int = MIN_KC, min_hw: int = MIN_HW) -> None:
    """Serve every site of ``net`` from ``cal`` in the ``scales`` mode, or
    run every site exact when ``cal`` is None. The ``dynamic`` mode takes no
    calibration: each site's weights are quantized per output channel here,
    as they are, and the gates are ``min_kc`` and ``min_hw``."""
    dynamic = scales == "dynamic"
    if dynamic and cal is not None:
        raise ValueError("the dynamic int8 mode takes no calibration")
    if cal is not None:
        min_kc, min_hw = cal.min_kc, cal.min_hw
    for n, conv in sites_of(net).items():
        conv.int8 = None
        if cal is None and not dynamic:
            continue
        if conv.int8_unported:
            conv.int8 = Unported(n, min_kc, min_hw)
        elif dynamic:
            kq, sw = quantize_per_out_channel(conv.weight)
            conv.int8 = Served(dict(kq=kq, sw=sw), scales, min_kc, min_hw)
        elif n in cal.sites:
            conv.int8 = Served(cal.sites[n], scales, min_kc, min_hw)
        else:
            raise KeyError(f"the int8 calibration has no entry for the site {n}")
