"""K10 at the fusion head's int8 sites, which the JAX package runs in
space-to-depth form (``ops/s2d.py``) and the port runs in the plain layout:
the C2F ``output_conv2`` (``qsd_0``, the stride-2 ``conv_down_expanded``
then a ReLU) and the head GatedConvUnit's ``conv`` and ``fusion_conv[0]``
(``qamax_0``, ``qamax_1``: 3x3 convs with ``s2d_same_kernel``, whose
per-channel scales are per (pixel phase, channel)).

Inputs are numpy arrays from a seed, handed to both sides. The JAX functions
run under ``jax.jit`` on the space-to-depth maps with the expanded kernels,
and their outputs are compared after ``depth_to_space``; the port runs on
CPU tensors, so ``quant_conv`` takes its plain version. The int8 operands
(the quantized input, the weights and their scales) and the int32 sums must
be equal. The outputs must be within 1e-6 of the magnitude in float32: under
``jit`` XLA on the CPU computes ``f32(acc) * scale + bias`` as one fused
multiply-add, while the port (and the reference without ``jit``) rounds the
product and the sum (measured: at most 7.7e-8); in bfloat16 within one
output rounding (2^-8 of the magnitude).
The JAX blocks run under ``monkeypatch`` env (``PRV2_INT8``,
``PRV2_INT8_FORCE``, ``PRV2_INT8_PERCHAN``, ``PRV2_INT8_MIN_KC``,
``PRV2_INT8_MIN_HW``; the default skip list) without ``jit``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.blocks.dpt import GatedConvUnit as JGated
from patchrefinerv2_tpu.ops import quant as _jq
from patchrefinerv2_tpu.ops import s2d

from patchrefinerv2_torch.models.blocks.convs import to_nhwc
from patchrefinerv2_torch.models.blocks.dpt import GatedConvUnit
from patchrefinerv2_torch.models.int8 import Int8Calibration, calibration, record, serve
from patchrefinerv2_torch.ops import quant as pq
from patchrefinerv2_torch.utils.jax_weights import (
    _phased_kernel, _s2d_channels, load_jax_int8, load_jax_params,
)
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_modules import init_random, nchw
from tests.test_torch_quant import _jax_dynamic, _jax_int8

T = torch.from_numpy
# the JAX quant functions as the reference runs them, under jit
jq = SimpleNamespace(
    _quantize_per_out_channel=jax.jit(_jq._quantize_per_out_channel),
    _fold_act_scales=jax.jit(_jq._fold_act_scales),
    **{n: jax.jit(getattr(_jq, n), static_argnames=("strides", "padding"))
       for n in ("quant_conv_same", "quant_conv_same_perchan")})
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _port(a, dt):
    return T(np.ascontiguousarray(np.asarray(jnp.asarray(a).astype(jnp.float32)))).to(_TORCH[dt])


def _bar(dt):
    return 1e-6 if dt == jnp.float32 else 2.0 ** -8


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# (scale mode, dtype, input part widths, Cout, relu_in + residual): the head
# unit's conv (one part, ReLU-in, + x) and fusion conv (cat(out, c_feat):
# the flagship's (32, 32) and narrow (8, 8))
S2D_CASES = [
    ("perchan", jnp.float32, (32,), 32, True),
    ("perchan", jnp.float32, (32, 32), 32, False),
    ("perchan", jnp.float32, (8, 8), 8, False),
    ("perchan", jnp.bfloat16, (32, 32), 32, False),
    ("perchan", jnp.bfloat16, (16,), 16, True),
    ("tensor", jnp.float32, (32,), 32, True),
    ("tensor", jnp.float32, (8, 8), 8, False),
    ("tensor", jnp.bfloat16, (32, 32), 32, False),
]


@pytest.mark.parametrize("mode,dt,widths,cout,relu_res", S2D_CASES)
def test_phased_plain_matches_jax_s2d(mode, dt, widths, cout, relu_res):
    """The port's plain-layout K10 (phased with per-channel scales) against
    ``quant_conv_same_perchan`` / ``quant_conv_same`` on the space-to-depth
    map ``cat(s2d(a), s2d(b))`` with ``s2d_same_kernel(k, split)``, the
    abs-maxes taken over the s2d map's 4C channels (0.8 of them, so the clip
    is reached; one phase of one channel at 0, the 1e-8 floor). The JAX
    calibration's folded weights, carried over by the loader's conversion,
    equal the port's own fold of the same abs-maxes."""
    rng = np.random.RandomState(sum(widths) + cout + len(widths))
    parts = [rng.randn(2, 8, 12, c).astype(np.float32) * (0.5 + rng.rand(c)) for c in widths]
    cin = sum(widths)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    kj, bj = jnp.asarray(k, dt), jnp.asarray(b, dt)
    pj = [jnp.asarray(p, dt) for p in parts]
    xs = jnp.concatenate([s2d.space_to_depth(p) for p in pj], -1)
    if relu_res:
        xs = jax.nn.relu(xs)
    kern = s2d.s2d_same_kernel(kj, split=widths if len(widths) > 1 else None)
    amax_c = np.abs(np.asarray(xs.astype(jnp.float32))).max(axis=(0, 1, 2)) * 0.8
    amax_c[1] = 0.0
    pos = _s2d_channels(widths)
    if mode == "perchan":
        folded, _ = jq._fold_act_scales(kern, jnp.asarray(amax_c))
        kqc_j, swc_j = jq._quantize_per_out_channel(folded)
        ref = jq.quant_conv_same_perchan(xs, kern, s2d.tile_bias(bj), jnp.asarray(amax_c),
                                         kqc_sw=(kqc_j, swc_j))
    else:
        amax = jnp.float32(amax_c.max())
        kq_j, sw_j = jq._quantize_per_out_channel(kern)
        ref = jq.quant_conv_same(xs, kern, s2d.tile_bias(bj), x_amax=amax, kq_sw=(kq_j, sw_j))
    if relu_res:
        ref = ref + s2d.space_to_depth(pj[0])
    ref = np.asarray(s2d.depth_to_space(ref).astype(jnp.float32))

    w = _port(kj, dt).permute(3, 2, 0, 1).contiguous()
    e = Int8Calibration.entry(w, T(amax_c[pos]), layout="s2d")
    if mode == "perchan":
        np.testing.assert_array_equal(e["kqc"].numpy(), _phased_kernel(kqc_j, "s2d", widths))
        np.testing.assert_array_equal(e["swc"].numpy(), np.asarray(swc_j).reshape(4, cout))
        args = (e["kqc"], pq.act_scale(e["amax_c"]), e["swc"])
    else:
        np.testing.assert_array_equal(e["kq"].numpy(), _phased_kernel(kq_j, "s2d", widths)[0])
        np.testing.assert_array_equal(e["sw"].numpy(), np.asarray(sw_j)[:cout])
        sx = pq.act_scale(torch.tensor(float(amax)))
        args = (e["kq"], sx.expand(cin).contiguous(), sx * e["sw"])
    xp = [_port(p, dt) for p in pj]
    # the quantized input and the int32 sums, phase by phase, are equal
    sx_j = np.maximum(amax_c, 1e-8) * np.float32(1 / 127) if mode == "perchan" else None
    if mode == "perchan":
        xq_j = jnp.clip(jnp.round(xs.astype(jnp.float32) / sx_j), -127, 127).astype(jnp.int8)
        acc_j = jax.lax.conv_general_dilated(xq_j, kqc_j, (1, 1), "SAME",
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                             preferred_element_type=jnp.int32)
        xcat = torch.cat(xp, -1)
        ph = pq.pixel_phase(*xcat.shape[1:3])
        xq = pq.quantize(torch.relu(xcat) if relu_res else xcat, args[1][ph])
        xq_parts = jnp.split(xq_j.astype(jnp.float32), np.cumsum([4 * c for c in widths])[:-1], axis=-1)
        np.testing.assert_array_equal(
            xq.numpy(), np.concatenate([np.asarray(s2d.depth_to_space(q)) for q in xq_parts], -1))
        acc = sum(pq.int8_conv_sums(xq, args[0][g]) * (ph[..., None] == g) for g in range(4))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(s2d.depth_to_space(acc_j)))
    got = pq.quant_conv(xp, *args, _port(bj, dt), relu_in=relu_res,
                        residual=xp[0] if relu_res else None)
    assert got.dtype == _TORCH[dt]
    assert _rel(got.float().numpy(), ref) <= _bar(dt)


@pytest.mark.parametrize("mode,dt", [("perchan", jnp.float32), ("tensor", jnp.float32),
                                     ("perchan", jnp.bfloat16)])
def test_qsd_matches_jax_down_expanded(mode, dt):
    """``qsd_0``: the reference's ``quant_conv_same*`` with the stride-2
    ``s2d_down_kernel`` on the full-resolution map (``conv_down_expanded``'s
    strides and pads), then a ReLU, against the port's plain 3x3 K10 with
    ``relu_out``. Its input is the plain map, so its scales are phase-free
    in every mode."""
    rng = np.random.RandomState(3 if mode == "perchan" else 4)
    cin, cout = 48, 16
    x = (rng.randn(2, 10, 14, cin) * (0.5 + rng.rand(cin))).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    xj, kj, bj = jnp.asarray(x, dt), jnp.asarray(k, dt), jnp.asarray(b, dt)
    k4, b4 = s2d.s2d_down_kernel(kj), s2d.tile_bias(bj)
    amax_c = np.abs(np.asarray(xj.astype(jnp.float32))).max(axis=(0, 1, 2)) * 0.8
    conv = dict(strides=(2, 2), padding=((1, 1), (1, 1)))
    if mode == "perchan":
        folded, _ = jq._fold_act_scales(k4, jnp.asarray(amax_c))
        kqc_j, swc_j = jq._quantize_per_out_channel(folded)
        ref = jq.quant_conv_same_perchan(xj, k4, b4, jnp.asarray(amax_c), kqc_sw=(kqc_j, swc_j), **conv)
    else:
        amax = jnp.float32(amax_c.max())
        kq_j, sw_j = jq._quantize_per_out_channel(k4)
        ref = jq.quant_conv_same(xj, k4, b4, x_amax=amax, kq_sw=(kq_j, sw_j), **conv)
    ref = np.asarray(s2d.depth_to_space(jax.nn.relu(ref)).astype(jnp.float32))

    w = _port(kj, dt).permute(3, 2, 0, 1).contiguous()
    e = Int8Calibration.entry(w, T(amax_c), layout="s2d_down")
    if mode == "perchan":
        np.testing.assert_array_equal(e["kqc"].numpy(), _phased_kernel(kqc_j, "s2d_down", (cin,))[0])
        np.testing.assert_array_equal(np.tile(e["swc"].numpy(), 4), np.asarray(swc_j))
        args = (e["kqc"], pq.act_scale(e["amax_c"]), e["swc"])
    else:
        sx = pq.act_scale(torch.tensor(float(amax)))
        args = (e["kq"], sx.expand(cin).contiguous(), sx * e["sw"])
    got = pq.quant_conv([_port(xj, dt)], *args, _port(bj, dt), relu_out=True)
    assert float(got.min()) >= 0.0
    assert _rel(got.float().numpy(), ref) <= _bar(dt)


def test_phase_of_a_pixel():
    """``ph(h, w) = 2 * (h % 2) + (w % 2)`` is the group-major order of
    ``space_to_depth``: channel block g of the s2d map holds the pixels of
    phase g."""
    x = np.arange(4 * 6, dtype=np.float32).reshape(1, 4, 6, 1)
    xs = np.asarray(s2d.space_to_depth(jnp.asarray(x)))
    ph = pq.pixel_phase(4, 6).numpy()
    for g in range(4):
        np.testing.assert_array_equal(np.sort(xs[0, :, :, g].ravel()), np.sort(x[0, :, :, 0][ph == g]))


def _head_unit(seed):
    """The head GatedConvUnit (16 channels, a 12-channel coarse level) on
    JAX's s2d side and the port's plain side, same weights, and its inputs."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 10, 12, 16).astype(np.float32)
    c = rng.randn(2, 10, 12, 12).astype(np.float32)
    jm = JGated(16, s2d=True)
    args = (s2d.space_to_depth(jnp.asarray(x)), s2d.space_to_depth(jnp.asarray(c)))
    v = init_random(jm, seed + 1, *args)
    port = GatedConvUnit(16, 12, tail=True).eval()
    load_jax_params(port, v, part="GatedConvUnit")
    return jm, v, args, port, (nchw(x), nchw(c))


@pytest.mark.parametrize("scales", ["perchan", "tensor", "dynamic"])
def test_head_unit_int8_matches_jax(monkeypatch, scales):
    """The head GatedConvUnit in int8 (float32, forced; ``min_kc`` 576 lets
    the 16-channel unit's expanded 3x3 kernels, 9 * 4 * 16, pass; its 1x1's
    4 * 16 does not) against the JAX unit in s2d form: calibrated (the JAX
    calibration carried over by ``load_jax_int8``, whose per-phase entries
    must equal the port's own fold of the carried abs-maxes, and whose
    abs-maxes the port's own calibration must match within 1e-5) or
    dynamic. The block runs without ``jit``, so JAX's ``/ 127.0`` is a true
    division there and its scales may differ from the port's in the last
    bit (the quantized weights are equal). Bar: max |port - JAX| / max |JAX|
    <= 1e-5 (the block bar)."""
    jm, v, args, port, xp = _head_unit(30)
    if scales == "dynamic":
        out_j = _jax_dynamic(monkeypatch, jm, v, args)
        serve(port, None, "dynamic", 576, 0)
    else:
        _, out_j, cal_vars = _jax_int8(monkeypatch, jm, v, args, scales == "perchan")
        cal = load_jax_int8(port, cal_vars, part="GatedConvUnit", min_kc=576, min_hw=0)
        assert sorted(cal.sites) == ["conv", "fusion_conv.0"]
        for n, e in cal.sites.items():
            assert e["layout"] == "s2d" and tuple(e["amax_c"].shape) == (4, port.get_submodule(n).in_channels)
            own = Int8Calibration.entry(port.get_submodule(n).weight, e["amax_c"], layout="s2d")
            for key in ("kq", "kqc"):
                np.testing.assert_array_equal(own[key].numpy(), e[key].numpy(), err_msg=f"{n} {key}")
            for key in ("sw", "swc"):  # the block runs without jit: `/ 127.0` is a true division
                np.testing.assert_allclose(own[key].numpy(), e[key].numpy(), rtol=2 ** -22,
                                           err_msg=f"{n} {key}")
        with torch.no_grad():
            recs = record(port)
            port(*xp)
        mine = calibration(port, recs, 576, 0)
        assert sorted(mine.selected()) == ["conv", "fusion_conv.0"]
        for n, e in cal.sites.items():
            np.testing.assert_allclose(mine.sites[n]["amax_c"].numpy(), e["amax_c"].numpy(), rtol=1e-5)
        serve(port, cal, scales)
    with torch.no_grad():
        got = to_nhwc(port(*xp)).numpy()
        serve(port, None)
        exact = to_nhwc(port(*xp)).numpy()
    ref = np.asarray(s2d.depth_to_space(out_j))
    err = _rel(got, ref)
    print(f"head unit {scales}: max rel {err:.3g}")
    assert err <= 1e-5, err
    assert _rel(got, exact) > 1e-4


def test_head_unit_odd_size():
    """At an odd H or W the reference runs the head in the plain layout under
    other site names (``blocks/dpt.py:365``). The port's head unit there:
    exact where the plain gate leaves it exact (the default gates, always),
    ``NotImplementedError`` where the gate would select it, and in
    calibration."""
    rng = np.random.RandomState(2)
    port = GatedConvUnit(16, 12, tail=True).eval()
    even = (nchw(rng.randn(1, 6, 8, 16).astype(np.float32)), nchw(rng.randn(1, 6, 8, 12).astype(np.float32)))
    odd = (nchw(rng.randn(1, 5, 8, 16).astype(np.float32)), nchw(rng.randn(1, 5, 8, 12).astype(np.float32)))
    with torch.no_grad():
        recs = record(port)
        port(*even)
        cal = calibration(port, recs, 0, 0)
        recs = record(port)
        with pytest.raises(NotImplementedError, match="odd"):
            port(*odd)
        serve(port, None)
        exact = port(*odd)
        cal.min_kc, cal.min_hw = 1152, 8192
        serve(port, cal, "perchan")
        assert torch.equal(port(*odd), exact)
        for scales in ("perchan", "tensor"):
            cal.min_kc, cal.min_hw = 0, 0
            serve(port, cal, scales)
            with pytest.raises(NotImplementedError, match="odd"):
                port(*odd)
        serve(port, None, "dynamic", 0, 0)
        with pytest.raises(NotImplementedError, match="odd"):
            port(*odd)
        serve(port, None)


def test_head_k5_1x1_raises_when_selected():
    """The head unit's 1x1 inside K5 (JAX ``qamax_2``, expanded to 4C x 4C):
    exact at the default gates (4 * 32 = 128 at the flagship, 512 at DA2,
    both below 1152), ``NotImplementedError`` where the gate would select
    it."""
    rng = np.random.RandomState(6)
    port = GatedConvUnit(16, 12, tail=True).eval()
    xp = (nchw(rng.randn(1, 6, 8, 16).astype(np.float32)), nchw(rng.randn(1, 6, 8, 12).astype(np.float32)))
    assert not pq.site_selected((32, 32, 1, 1), 192 * 256 * 4, 1152, 8192, "s2d")
    assert not pq.site_selected((128, 128, 1, 1), 224 * 224 * 4, 1152, 8192, "s2d")
    with torch.no_grad():
        recs = record(port)
        port(*xp)
        cal = calibration(port, recs, 64, 0)  # 4 * 16: the 1x1 would pass
        serve(port, cal)
        with pytest.raises(NotImplementedError, match="K5"):
            port(*xp)
        cal.min_kc = 65
        serve(port, cal)
        port(*xp)
        serve(port, None)


def test_head_site_gate_counts_s2d_shapes():
    """The gate at the head sites counts the reference's space-to-depth
    shapes: the head unit's 3x3 at the flagship (32 channels) gives 9 * 4 *
    32 = 1152 on the (H/2)(W/2) map, ``output_conv2``'s stride-2 kernel 16 *
    4 * 32 = 2048 on the H x W map; the plain shapes would give 288."""
    hw = 384 * 512
    assert pq.site_selected((32, 32, 3, 3), hw, 1152, 8192, "s2d")
    assert pq.site_selected((32, 128, 3, 3), hw, 1152, 8192, "s2d_down")
    assert not pq.site_selected((32, 32, 3, 3), hw, 1152, 8192)
    assert not pq.site_selected((32, 32, 3, 3), 4 * 8191, 1152, 8192, "s2d")
    assert pq.site_selected((128, 256, 3, 3), 448 * 448, 1152, 8192, "s2d")
    assert not pq.site_selected((17, 128, 3, 3), hw, 1152, 8192, "s2d_down")
