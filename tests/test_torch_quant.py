"""K10, the int8 convolution: the plain version of the port's ``quant_conv``
and its quantize helpers against the JAX package's ``ops/quant.py``, the
port's int8 sites block by block against the JAX blocks' calibrate, fold and
serve flow, and the sites the gate selects at the full patch shapes.

Inputs are numpy arrays from a seed, handed to both sides; the port runs on
CPU tensors, so ``quant_conv`` takes its plain version. Both sides quantize
in float32 with a true division and round half to even, and sum the int8
products exactly, so the functions' quantized operands and int32 sums must
be equal and their outputs within 1e-6 relative (they are bit-equal). The
JAX functions run under ``jax.jit``, as the reference always runs them:
there XLA computes their ``/ 127.0`` scales as a product with the float32
reciprocal, which the port follows (``ops/quant.py`` ``act_scale``). The
JAX side runs under ``monkeypatch`` env (``PRV2_INT8``, ``PRV2_INT8_FORCE``,
``PRV2_INT8_PERCHAN``, ``PRV2_INT8_MIN_KC`` 576, ``PRV2_INT8_MIN_HW`` 0,
and no ``PRV2_INT8_SKIP``: the reference's default skip list,
``tailfuse,taildc``); the blocks are applied without ``jit``, so no int8
trace outlives its test.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.backbones.encoders import MBConv as JMBConv
from patchrefinerv2_tpu.models.blocks.convs import DoubleConv as JDoubleConv
from patchrefinerv2_tpu.models.blocks.convs import SingleConvCNNLN as JSingle
from patchrefinerv2_tpu.models.blocks.dpt import C2FModule as JC2F
from patchrefinerv2_tpu.models.blocks.dpt import GatedConvUnit as JGated
from patchrefinerv2_tpu.ops import quant as _jq
from patchrefinerv2_tpu.ops import s2d

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models.backbones.encoders import DepthwiseSeparable, InvertedResidual
from patchrefinerv2_torch.models.blocks.convs import DoubleConv, SingleConvCNNLN, to_nhwc
from patchrefinerv2_torch.models.blocks.dpt import C2FModule, GatedConvUnit
from patchrefinerv2_torch.models.int8 import calibration, record, serve, sites_of
from patchrefinerv2_torch.models.patchrefinerplus import PRPlusNet
from patchrefinerv2_torch.ops import _cuda
from patchrefinerv2_torch.ops import quant as pq
from patchrefinerv2_torch.utils.jax_weights import load_jax_int8, load_jax_params
from tests.test_torch_modules import _COARSE, _FINE, init_random, nchw

T = torch.from_numpy


# the JAX quant functions as the reference runs them, under jit
jq = SimpleNamespace(**{n: jax.jit(getattr(_jq, n)) for n in (
    "_quantize_per_tensor", "_quantize_per_out_channel", "_fold_act_scales", "quant_conv_same",
    "quant_conv_same_perchan")})
MIN_KC, MIN_HW = 576, 0  # the lowered gates of the block tests


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _kernel(rng, k, cin, cout, dt):
    """A JAX (k, k, cin, cout) kernel in ``dt`` and the port's (cout, cin, k, k) view."""
    kern = jnp.asarray(rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin), dt)
    kf = np.asarray(kern.astype(jnp.float32))
    return kern, T(np.ascontiguousarray(kf.transpose(3, 2, 0, 1))).to(_TORCH[dt])


_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _to_port(a, dt):
    return T(np.ascontiguousarray(np.asarray(jnp.asarray(a).astype(jnp.float32)))).to(_TORCH[dt])


# ---------------------------------------------------------------- the functions
# (scale mode, dtype, k, input part widths, Cout, bias, relu_in + residual)
FUNCTION_CASES = [
    ("tensor", jnp.float32, 3, (40,), 20, True, False),
    ("tensor", jnp.bfloat16, 1, (33,), 8, False, False),
    ("tensor", jnp.bfloat16, 3, (24,), 24, True, True),
    ("perchan", jnp.float32, 3, (98,), 20, True, False),
    ("perchan", jnp.bfloat16, 1, (40,), 33, False, False),
    ("perchan", jnp.float32, 3, (24, 17), 24, True, False),
    ("perchan", jnp.bfloat16, 3, (32, 32), 32, True, False),
    ("perchan_fold", jnp.bfloat16, 3, (24,), 12, True, False),
    ("perchan_fold", jnp.float32, 3, (16,), 16, False, True),
]


@pytest.mark.parametrize("mode,dt,k,widths,cout,use_bias,relu_res", FUNCTION_CASES)
def test_quant_conv_plain_matches_jax(mode, dt, k, widths, cout, use_bias, relu_res):
    """``quant_conv_plain`` against ``quant_conv_same`` (calibrated ``x_amax``
    and pre-quantized ``kq_sw``) and ``quant_conv_same_perchan`` (with the
    calibrated ``kqc_sw``, or folding in-graph: ``perchan_fold``), with the
    abs-max below the input's own (so the clip is reached) and one channel's
    at 0 (the 1e-8 floor). 2 parts are concatenated on the JAX side; ReLU-in
    and the residual follow the JAX expression ``quant_conv(relu(x)) + x``."""
    rng = np.random.RandomState(sum(widths) + cout + k)
    parts_j = [jnp.asarray(rng.randn(2, 9, 13, c) * 2, dt) for c in widths]
    x = jnp.concatenate(parts_j, axis=-1)
    xin = jax.nn.relu(x) if relu_res else x
    kern, w_port = _kernel(rng, k, sum(widths), cout, dt)
    bias = jnp.asarray(rng.randn(cout) * 0.1, dt) if use_bias else None
    xf = np.abs(np.asarray(xin.astype(jnp.float32)))
    amax = jnp.float32(xf.max() * 0.7)
    amax_c = jnp.asarray(xf.max(axis=(0, 1, 2)) * 0.8, jnp.float32).at[1].set(0.0)

    if mode == "tensor":
        kq_j, sw_j = jq._quantize_per_out_channel(kern)
        ref = jq.quant_conv_same(xin, kern, bias, x_amax=amax, kq_sw=(kq_j, sw_j))
        xq_j, sx_j = jq._quantize_per_tensor(xin, amax)
        kq, sw = pq.quantize_per_out_channel(w_port)
        sx_t = pq.act_scale(torch.tensor(np.asarray(amax)))
        assert float(sx_t) == float(sx_j)
        sx, scale = sx_t.expand(sum(widths)).contiguous(), sx_t * sw
    else:
        folded, sxc_j = jq._fold_act_scales(kern, amax_c)
        kq_j, sw_j = jq._quantize_per_out_channel(folded)
        ref = jq.quant_conv_same_perchan(xin, kern, bias, amax_c,
                                         kqc_sw=None if mode == "perchan_fold" else (kq_j, sw_j))
        xq_j = jnp.clip(jnp.round(xin.astype(jnp.float32) / sxc_j), -127, 127).astype(jnp.int8)
        folded_p, sx = pq.fold_act_scales(w_port, T(np.asarray(amax_c)))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(sxc_j))
        np.testing.assert_array_equal(folded_p.numpy(), np.asarray(folded).transpose(3, 2, 0, 1))
        kq, scale = pq.quantize_per_out_channel(folded_p)
        sw = scale
    if relu_res:
        ref = ref + x
    parts = [_to_port(p, dt) for p in parts_j]
    xport = torch.relu(torch.cat(parts, -1)) if relu_res else torch.cat(parts, -1)

    # the quantized operands and the int32 sums are equal
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_j).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j))
    xq = pq.quantize(xport, sx)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    acc_j = jax.lax.conv_general_dilated(xq_j, kq_j, (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                         preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(pq.int8_conv_sums(xq, kq).numpy(), np.asarray(acc_j))
    assert (np.abs(np.asarray(xq_j)) == 127).any()  # the clip is reached

    got = pq.quant_conv(parts, kq, sx, scale, None if bias is None else _to_port(bias, dt),
                        relu_in=relu_res, residual=parts[0] if relu_res else None)
    assert got.dtype == _TORCH[dt] and tuple(got.shape) == tuple(ref.shape)
    assert _rel(got.float().numpy(), ref.astype(jnp.float32)) <= 1e-6


def test_quantize_helpers_match_jax():
    """Half-to-even ties, the +-127 clip and the abs-max floor of 1e-8, per
    tensor and per output channel, against the JAX helpers."""
    # abs-max 15.875 gives the scale 0.125 exactly, so x / sx lands on the ties
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -127.5, 300.0, -1e9],
                    np.float32) * np.float32(0.125)
    xq_j, sx_j = jq._quantize_per_tensor(jnp.asarray(ties), jnp.float32(15.875))
    assert float(sx_j) == 0.125
    got = pq.quantize(T(ties), pq.act_scale(torch.tensor(15.875)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(got.numpy(), [0, 2, 2, 0, -2, -2, 126, 127, -127, 127, -127])
    # the floor: an abs-max of 0 gives the scale 1e-8 / 127, and zeros stay 0
    zero = torch.zeros(4)
    assert float(pq.act_scale(torch.tensor(0.0))) == float(
        jq._quantize_per_tensor(jnp.zeros(4), jnp.float32(0.0))[1])
    assert not pq.quantize(zero, pq.act_scale(torch.tensor(0.0))).any()
    # per output channel: one channel all zero (the floor), one with ties
    rng = np.random.RandomState(3)
    k = (rng.randn(3, 3, 5, 4) * 0.3).astype(np.float32)
    k[..., 2] = 0.0
    k[0, 0, 0, 3], k[0, 0, 1, 3] = 1.27, 0.005  # 0.005 / (1.27 / 127) = 0.5
    kq_j, sw_j = jq._quantize_per_out_channel(jnp.asarray(k))
    kq, sw = pq.quantize_per_out_channel(T(np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_j).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j))
    assert not kq[2].any()


def test_site_selected_is_the_reference_gate():
    assert pq.site_selected((128, 256, 3, 3), 8192, 1152, 8192)
    assert not pq.site_selected((127, 256, 3, 3), 8192, 1152, 8192)
    assert not pq.site_selected((256, 256, 3, 3), 8191, 1152, 8192)
    assert not pq.site_selected((1056, 176, 1, 1), 10 ** 6, 1152, 8192)
    assert pq.site_selected((1824, 304, 1, 1), 8192, 1152, 8192)


def test_format_weight_layout():
    """The kernel's weight layout: for each N tile (here one of 32 for Cout
    20) [Cin / 32][phase][half][tap][N][16], flat, zeros past the real input
    and output channels."""
    kq = torch.randint(-127, 128, (20, 40, 3, 3), dtype=torch.int8)
    wf = pq.format_weight(kq)
    assert tuple(wf.shape) == (2 * 1 * 2 * 9 * 32 * 16,)
    wf = wf.reshape(2, 1, 2, 9, 32, 16)
    for ch, half, tap, o, i in ((0, 0, 0, 0, 0), (1, 0, 4, 19, 7), (0, 1, 8, 5, 15)):
        assert int(wf[ch, 0, half, tap, o, i]) == int(kq[o, ch * 32 + half * 16 + i, tap // 3, tap % 3])
    assert not wf[1, :, 0, :, :, 8:].any() and not wf[1, :, 1].any() and not wf[:, :, :, :, 20:].any()


# ---------------------------------------------------------------- the blocks
def _jax_int8(monkeypatch, mod, v, args, perchan):
    """The JAX block's calibrate (stats pass, fold, finalize pass) and serve
    flow at the lowered gates: (exact output, int8 output, variables with
    ``quant_scales`` and ``quant_kq``)."""
    from patchrefinerv2_tpu.ops.quant import scales_from_stats

    for k in ("PRV2_INT8", "PRV2_INT8_FORCE", "PRV2_INT8_PERCHAN", "PRV2_INT8_CALIB", "PRV2_INT8_SKIP"):
        monkeypatch.delenv(k, raising=False)
    exact = mod.apply(v, *args)
    monkeypatch.setenv("PRV2_INT8_CALIB", "1")
    _, st = mod.apply(v, *args, mutable=["quant_stats", "quant_kq"])
    scales = scales_from_stats([st["quant_stats"]])
    _, st = mod.apply({**v, "quant_scales": scales}, *args, mutable=["quant_stats", "quant_kq"])
    monkeypatch.delenv("PRV2_INT8_CALIB")
    cal_vars = {**v, "quant_scales": scales, "quant_kq": st["quant_kq"]}
    monkeypatch.setenv("PRV2_INT8", "1")
    monkeypatch.setenv("PRV2_INT8_FORCE", "1")
    monkeypatch.setenv("PRV2_INT8_MIN_KC", str(MIN_KC))
    monkeypatch.setenv("PRV2_INT8_MIN_HW", str(MIN_HW))
    if perchan:
        monkeypatch.setenv("PRV2_INT8_PERCHAN", "1")
    out = mod.apply(cal_vars, *args)
    for k in ("PRV2_INT8", "PRV2_INT8_FORCE", "PRV2_INT8_PERCHAN", "PRV2_INT8_MIN_KC",
              "PRV2_INT8_MIN_HW"):
        monkeypatch.delenv(k, raising=False)
    return exact, out, cal_vars


def _jax_dynamic(monkeypatch, mod, v, args):
    """The JAX module's dynamic int8 output (``PRV2_INT8`` without
    ``quant_scales``) at the lowered gates."""
    for k, val in (("PRV2_INT8", "1"), ("PRV2_INT8_FORCE", "1"), ("PRV2_INT8_MIN_KC", str(MIN_KC)),
                   ("PRV2_INT8_MIN_HW", str(MIN_HW))):
        monkeypatch.setenv(k, val)
    for k in ("PRV2_INT8_PERCHAN", "PRV2_INT8_CALIB", "PRV2_INT8_SKIP"):
        monkeypatch.delenv(k, raising=False)
    out = mod.apply(v, *args)
    for k in ("PRV2_INT8", "PRV2_INT8_FORCE", "PRV2_INT8_MIN_KC", "PRV2_INT8_MIN_HW"):
        monkeypatch.delenv(k)
    return out


def _mbconv(cin, cout, expand):
    jm = JMBConv(out_ch=cout, kernel=3, stride=1, expand=expand, se_reduced=max(1, cin // 4))
    if expand == 1:
        port = DepthwiseSeparable(cin, cout, 3, 1, max(1, cin // 4))
    else:
        port = InvertedResidual(cin, cin * expand, cout, 3, 1, max(1, cin // 4))
    return jm, port, "MBConv"


# (name, JAX module, port module, weight part, NHWC input shapes, extra JAX
# apply args, the port sites the lowered gates select)
def _block(name):
    if name == "inverted_residual":
        jm, port, part = _mbconv(96, 576, 6)
        return jm, port, part, [(1, 6, 8, 96)], (False,), ["conv_pw", "conv_pwl"]
    if name == "depthwise_separable":
        jm, port, part = _mbconv(64, 576, 1)
        return jm, port, part, [(1, 6, 8, 64)], (False,), ["conv_pw"]
    if name == "single_conv_cnn_ln":
        return (JSingle(64), SingleConvCNNLN(64, 64), "SingleConvCNNLN", [(2, 7, 9, 40), (2, 7, 9, 24)],
                (), ["single_conv.0"])
    if name == "double_conv":
        return (JDoubleConv(64, 70), DoubleConv(50, 64, 70), "DoubleConv", [(2, 7, 9, 50)], (),
                ["double_conv.0", "double_conv.2"])
    if name == "double_conv_tail":
        return (JDoubleConv(32, 70, s2d_out=True), DoubleConv(50, 32, 70, tail=True), "DoubleConv",
                [(2, 8, 10, 50)], (), ["double_conv.0"])
    if name == "gated_conv_unit":
        return (JGated(64), GatedConvUnit(64, 24), "GatedConvUnit", [(2, 6, 8, 64), (2, 6, 8, 24)], (),
                ["conv", "fusion_conv.0"])
    raise KeyError(name)


BLOCKS = ["inverted_residual", "depthwise_separable", "single_conv_cnn_ln", "double_conv",
          "double_conv_tail", "gated_conv_unit"]


@pytest.mark.parametrize("perchan", [True, False], ids=["perchan", "tensor"])
@pytest.mark.parametrize("name", BLOCKS)
def test_block_int8_matches_jax(monkeypatch, name, perchan):
    """Each kind of int8 site as a block, float32 with the int8 path forced
    at the lowered gates. The JAX calibration is carried into the port by
    ``load_jax_int8``; the port's own calibration of the same input must
    agree with it. Bar: max |port - JAX| / max |JAX| <= 1e-5. The int8
    output must differ from the exact one (the int8 path ran)."""
    jm, port, part, shapes, extra, selected = _block(name)
    rng = np.random.RandomState(BLOCKS.index(name) + 40)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    jargs = ((jnp.concatenate([jnp.asarray(x) for x in xs], -1),) if name == "single_conv_cnn_ln"
             else tuple(jnp.asarray(x) for x in xs)) + extra
    v = init_random(jm, 13, *jargs)
    exact_j, out_j, cal_vars = _jax_int8(monkeypatch, jm, v, jargs, perchan)
    if name == "double_conv_tail":  # the JAX tail form returns space-to-depth
        exact_j, out_j = s2d.depth_to_space(exact_j), s2d.depth_to_space(out_j)
    port = port.eval()
    load_jax_params(port, v, part=part)
    xp = [nchw(x) for x in xs]
    cal = load_jax_int8(port, cal_vars, part=part, min_kc=MIN_KC, min_hw=MIN_HW)
    assert sorted(cal.sites) == sorted(n for n, c in sites_of(port).items() if not c.int8_unported)
    with torch.no_grad():
        recs = record(port)
        port(*xp)
        own = calibration(port, recs, MIN_KC, MIN_HW)
        assert sorted(own.selected()) == sorted(selected)
        for n, e in cal.sites.items():  # the port's calibration agrees with JAX's
            np.testing.assert_allclose(own.sites[n]["amax_c"].numpy(), e["amax_c"].numpy(), rtol=1e-5)
            np.testing.assert_array_equal(own.sites[n]["kq"].numpy(), e["kq"].numpy())
        serve(port, cal, "perchan" if perchan else "tensor")
        got = to_nhwc(port(*xp)).numpy()
        serve(port, None)
        exact = to_nhwc(port(*xp)).numpy()
    err = _rel(got, out_j)
    print(f"{name} {'perchan' if perchan else 'tensor'}: max rel {err:.3g}")  # shown with pytest -s
    assert err <= 1e-5, err
    assert _rel(exact, exact_j) <= 1e-5
    assert _rel(got, exact) > 1e-4  # the int8 path ran on both sides
    assert _rel(out_j, exact_j) > 1e-4


@pytest.mark.parametrize("name", BLOCKS)
def test_block_int8_dynamic_matches_jax(monkeypatch, name):
    """Each kind of int8 site as a block in the dynamic mode (no
    calibration: one activation scale per call from the input's live
    abs-max, the weights quantized per output channel), float32 with the
    int8 path forced at the lowered gates, against the JAX block with
    ``PRV2_INT8=1`` and no ``quant_scales``. Bar: max |port - JAX| / max
    |JAX| <= 1e-5, as with calibrated scales: both sides take the same
    abs-max of the same input. The int8 output must differ from the exact
    one."""
    jm, port, part, shapes, extra, _ = _block(name)
    rng = np.random.RandomState(BLOCKS.index(name) + 60)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    jargs = ((jnp.concatenate([jnp.asarray(x) for x in xs], -1),) if name == "single_conv_cnn_ln"
             else tuple(jnp.asarray(x) for x in xs)) + extra
    v = init_random(jm, 17, *jargs)
    exact_j = jm.apply(v, *jargs)
    out_j = _jax_dynamic(monkeypatch, jm, v, jargs)
    if name == "double_conv_tail":  # the JAX tail form returns space-to-depth
        exact_j, out_j = s2d.depth_to_space(exact_j), s2d.depth_to_space(out_j)
    port = port.eval()
    load_jax_params(port, v, part=part)
    xp = [nchw(x) for x in xs]
    with torch.no_grad():
        serve(port, None, "dynamic", MIN_KC, MIN_HW)
        got = to_nhwc(port(*xp)).numpy()
        serve(port, None)
    err = _rel(got, out_j)
    print(f"{name} dynamic: max rel {err:.3g}")
    assert err <= 1e-5, err
    assert _rel(got, exact_j) > 1e-4


def test_c2f_module_int8_matches_jax(monkeypatch):
    """C2FModule at the lowered gates, its head in space-to-depth form on the
    JAX side (``s2d_tail``, as BiDirectionalFusion runs it): every refinenet
    unit's two 3x3 convs and ``output_conv1`` are int8 (19 sites in a
    chain). The three head sites (``qsd_0`` and the head unit's ``qamax_0``
    and ``qamax_1``) are calibrated on both sides and carried across, but at
    8 channels their expanded kernels (288, 512) stay below the lowered
    ``min_kc``: with 16 channels the port's own int8 output moves by 1.7e-3
    mean rel when its input moves by 1e-7 relative, the head's int8 steps
    landing on the output directly, so this bar cannot hold there
    (``tests/test_torch_quant_head.py`` holds the head unit to 1e-5 alone).
    Per-channel scales. Bar: mean rel < 1e-4 (rel to |JAX| floored at
    1e-3), the composed bar. Each site's inputs differ
    from JAX's by float32 rounding in the exact layers between the sites;
    where that flips a rounding of ``x / sx``, a value moves by one int8
    step, and the 3x3 convs and upsamples downstream spread it. Measured:
    max rel 3.4e-3 (99.9th percentile), 2.3e-3 of the output's magnitude at
    most, mean 5.3e-5; the int8 output differs from the exact one by far
    more."""
    rng = np.random.RandomState(8)
    fine = [rng.randn(2, h, w, c).astype(np.float32) for h, w, c in _FINE]
    coarse = [rng.randn(2, h, w, c).astype(np.float32) for h, w, c in _COARSE]
    jm = JC2F(features=128, head2_features=8, gate=True, fusion=True, s2d_tail=True)
    args = ([jnp.asarray(f) for f in fine], [jnp.asarray(c) for c in coarse])
    v = init_random(jm, 9, *args)
    (_, exact_j), (_, out_j), cal_vars = _jax_int8(monkeypatch, jm, v, args, True)
    port = C2FModule([s[2] for s in _FINE], [s[2] for s in _COARSE], features=128,
                     head2_features=8).eval()
    load_jax_params(port, v, part="C2FModule")
    cal = load_jax_int8(port, cal_vars, part="C2FModule", min_kc=MIN_KC, min_hw=MIN_HW)
    serve(port, cal, "perchan")
    with torch.no_grad():
        _, got = port([nchw(f) for f in fine], [nchw(c) for c in coarse])
        recs = record(port)
        port([nchw(f) for f in fine], [nchw(c) for c in coarse])
    own = calibration(port, recs, MIN_KC, MIN_HW)
    # 9 units with two 3x3 convs each (refinenet5 has one), and output_conv1
    assert "scratch.output_conv1" in own.selected() and len(own.selected()) == 19
    head = {"scratch.output_conv2.0": "s2d_down",
            "scratch.output_conv2_fusion.GateresConfUnit2.conv": "s2d",
            "scratch.output_conv2_fusion.GateresConfUnit2.fusion_conv.0": "s2d"}
    assert {n: cal.sites[n]["layout"] for n in head} == head == {n: own.sites[n]["layout"] for n in head}
    g, r = to_nhwc(got).numpy().astype(np.float64), np.asarray(out_j, np.float64)
    rel = np.abs(g - r) / np.maximum(np.abs(r), 1e-3)
    off = np.abs(np.asarray(exact_j, np.float64) - r) / np.maximum(np.abs(r), 1e-3)
    print(f"c2f: max {_rel(g, r):.3g} of the magnitude, rel mean {rel.mean():.3g} "
          f"p99.9 {np.quantile(rel, 0.999):.3g}; int8 vs exact mean {off.mean():.3g}")
    assert rel.mean() < 1e-4, rel.mean()
    assert off.mean() > 10 * rel.mean()


def test_k5_1x1_raises_when_selected():
    """The GatedConvUnit's 1x1 runs inside K5: where the gate would select it
    (JAX ``qamax_2``), the port raises rather than differ."""
    rng = np.random.RandomState(5)
    port = GatedConvUnit(16, 8).eval()
    x, c = nchw(rng.randn(1, 6, 8, 16).astype(np.float32)), nchw(rng.randn(1, 6, 8, 8).astype(np.float32))
    with torch.no_grad():
        recs = record(port)
        port(x, c)
        cal = calibration(port, recs, min_kc=0, min_hw=0)
        assert sorted(cal.sites) == ["conv", "fusion_conv.0"]
        serve(port, cal)
        with pytest.raises(NotImplementedError):
            port(x, c)
        cal.min_kc = 17  # above the 1x1's 16: served without it
        serve(port, cal)
        port(x, c)


def test_unmarked_tail_sites():
    """``tailfuse`` and ``taildc`` are not int8 sites (the reference's default
    skip list); the tail DoubleConv's first conv is. The head unit (``tail``)
    is marked in space-to-depth layout, as the reference dispatches it in
    s2d form: ``conv`` and ``fusion_conv[0]`` served, the 1x1 inside K5
    unported; without fusion its ``conv`` alone (``dpt.py:136-143``)."""
    single = SingleConvCNNLN(34, 32, tail=True)
    dc = DoubleConv(98, 32, 98, tail=True)
    unit = GatedConvUnit(32, 32, tail=True)
    assert sites_of(single) == {}
    assert list(sites_of(dc)) == ["double_conv.0"]
    marks = {n: (c.int8_site, c.int8_layout, c.int8_unported) for n, c in sites_of(unit).items()}
    assert marks == {"conv": ("qamax_0", "s2d", False), "fusion_conv.0": ("qamax_1", "s2d", False),
                     "fusion_conv.3": ("qamax_2", "s2d", True)}
    assert list(sites_of(GatedConvUnit(32, 32, fusion=False, tail=True))) == ["conv"]
    assert sites_of(GatedConvUnit(16, 8, fusion=False)) == {}  # not dispatched in JAX either


# the 12 plain-layout sites that the reference's gate selects at its defaults
# at the flagship's 384x512 patch and DA2's 448x448: port module -> (JAX
# scope, JAX site name)
SITES_12 = {
    "refiner_fusion_model.c2f.scratch.refinenet2.GateresConfUnit1.conv":
        ("fusion/c2f/refinenet2/GatedConvUnit_0", "qamax_0"),
    "refiner_fusion_model.c2f.scratch.refinenet2.GateresConfUnit2.conv":
        ("fusion/c2f/refinenet2/GatedConvUnit_1", "qamax_0"),
    "refiner_fusion_model.c2f.scratch.refinenet2.GateresConfUnit1.fusion_conv.0":
        ("fusion/c2f/refinenet2/GatedConvUnit_0", "qamax_1"),
    "refiner_fusion_model.c2f.scratch.refinenet2.GateresConfUnit2.fusion_conv.0":
        ("fusion/c2f/refinenet2/GatedConvUnit_1", "qamax_1"),
    "refiner_fusion_model.c2f.scratch.refinenet1.GateresConfUnit1.conv":
        ("fusion/c2f/refinenet1/GatedConvUnit_0", "qamax_0"),
    "refiner_fusion_model.c2f.scratch.refinenet1.GateresConfUnit2.conv":
        ("fusion/c2f/refinenet1/GatedConvUnit_1", "qamax_0"),
    "refiner_fusion_model.c2f.scratch.refinenet1.GateresConfUnit1.fusion_conv.0":
        ("fusion/c2f/refinenet1/GatedConvUnit_0", "qamax_1"),
    "refiner_fusion_model.c2f.scratch.refinenet1.GateresConfUnit2.fusion_conv.0":
        ("fusion/c2f/refinenet1/GatedConvUnit_1", "qamax_1"),
    "refiner_fusion_model.c2f.scratch.output_conv1": ("fusion/c2f", "qamax_0"),
    "refiner_fusion_model.f2r_agg.2.conv.double_conv.0": ("fusion/f2r_agg_2/DoubleConv_0", "qamax_0"),
    "refiner_fusion_model.f2r_agg.2.conv.double_conv.2": ("fusion/f2r_agg_2/DoubleConv_0", "qamax_1"),
    "refiner_fusion_model.f2r_agg.3.conv.double_conv.0": ("fusion/f2r_agg_3/DoubleConv_0", "qamax_0"),
}
# the 3 head sites that the reference runs in space-to-depth form and its
# default gates select on those shapes (the JAX site trace at 384x512 and
# 448x448): port module -> (JAX scope, JAX site name)
HEAD_SITES = {
    "refiner_fusion_model.c2f.scratch.output_conv2.0": ("fusion/c2f", "qsd_0"),
    "refiner_fusion_model.c2f.scratch.output_conv2_fusion.GateresConfUnit2.conv":
        ("fusion/c2f/output_conv2_fusion/GatedConvUnit_0", "qamax_0"),
    "refiner_fusion_model.c2f.scratch.output_conv2_fusion.GateresConfUnit2.fusion_conv.0":
        ("fusion/c2f/output_conv2_fusion/GatedConvUnit_0", "qamax_1"),
}
SITES_15 = {**SITES_12, **HEAD_SITES}


@pytest.mark.parametrize("config", ["configs/patchrefinerv2_zoedepth/v2_eff_u4k.py",
                                    "configs/patchrefinerv2_dav2/plus_eff_u4k.py"])
def test_full_shape_sites(monkeypatch, config):
    """The sites the default gates select at the full patch shape, found by
    a shape-only walk: the refiner and fusion head built on the ``meta``
    device and run on meta tensors (the wrappers' plain versions, which
    compute nothing there) with every site recording its input, the gate
    counting each site's shapes in the layout the reference runs it in.
    Exactly the 15 sites of the reference's default int8 mode: the 12
    plain-layout ones and the 3 space-to-depth head sites (DA2's head runs
    at 128 channels, ``coarse_chl[0]``); no encoder or SingleConvCNNLN
    site, no ``tailfuse`` or ``taildc`` site, and the head unit's 1x1
    (``qamax_2``, 4 * C below ``min_kc``) not selected."""
    monkeypatch.setattr(_cuda, "on_cpu", lambda t: t.device.type in ("cpu", "meta"))
    cfg = Config.fromfile(config).model.config
    with torch.device("meta"):
        net = PRPlusNet(cfg)
    h, w = net.patch_process_shape
    chl = net.coarse_branch.coarse_chl

    def meta(c, hh, ww):
        return torch.empty((16, c, hh, ww), device="meta").contiguous(memory_format=torch.channels_last)

    # coarse levels low -> high resolution, as refine takes them
    coarse = [meta(chl[5 - i], h >> (5 - i), w >> (5 - i)) for i in range(6)]
    recs = record(net)
    with torch.inference_mode():
        net.refine(meta(3, h, w), coarse, meta(1, h, w))
    sites = sites_of(net)
    selected = {n for n, r in recs.items()
                if pq.site_selected(sites[n].weight.shape, r.hw, 1152, 8192, sites[n].int8_layout)}
    assert selected == set(SITES_15)
    assert all(sites[n].int8_site == s for n, (_, s) in SITES_15.items())
    assert {sites[n].int8_layout for n in HEAD_SITES} == {"s2d", "s2d_down"}
    assert all(r.hw is not None for r in recs.values())  # every site ran
    assert not any("fusion_layers_1.0" in n or "fusion_layers_2.0" in n
                   or "f2r_agg.4.conv.double_conv.2" in n for n in sites)
