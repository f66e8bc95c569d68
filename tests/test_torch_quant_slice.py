"""The port's int8 serving mode on the composed slice against the JAX
package's default int8 mode: ``calibrate_int8``, the calibrated int8 m1 / m2
tiled inference and the dynamic (calibration-free) one.

The flagship slice of tests/test_torch_slice.py (a tiny BEiT ZoeDepth
coarse branch, the full EfficientNet-B5 refiner and BiDirectionalFusion,
48x64 patches of a 96x128 frame split 2x2, ``process_num=4``), float32 with
the int8 path forced. One JAX model is initialised for the module, its
variables are redrawn with numpy from a seed and loaded into the port; the
images are numpy arrays from a seed. The JAX side runs under ``monkeypatch``
env (``PRV2_INT8``, ``PRV2_INT8_FORCE``, ``PRV2_INT8_PERCHAN``,
``PRV2_INT8_MIN_HW``; no ``PRV2_INT8_SKIP``, so the reference's default skip
list ``tailfuse,taildc`` holds), and its jitted inference cache is cleared
before and after every int8 trace, so that no int8 trace reaches another
test. ``PRV2_INT8_MIN_HW`` 128 is the default 8192 scaled by the slice's
pixels (1/64 of the flagship's 384x512): with the default ``min_kc`` it
selects the same 15 sites, the slice's head running at the flagship's 32
channels.
"""

import numpy as np
import pytest
import torch

import jax

from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import load_jax_int8, load_jax_params
from tests.test_torch_modules import randomize
from tests.test_torch_quant import SITES_15
from tests.test_torch_slice import slice_config

MIN_HW = 128


def _clear_env(monkeypatch):
    for k in ("PRV2_INT8", "PRV2_INT8_FORCE", "PRV2_INT8_PERCHAN", "PRV2_INT8_MIN_KC",
              "PRV2_INT8_MIN_HW", "PRV2_INT8_CALIB", "PRV2_INT8_SKIP"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def both():
    """The JAX model and variables, its calibration over the frame (m1 and
    the three shifted passes), the port with the same weights, the frame."""
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=slice_config()))
    variables = randomize(jm.init(jax.random.PRNGKey(0)), seed=21)
    rng = np.random.RandomState(11)
    lr = rng.rand(1, 48, 64, 3).astype(np.float32)
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _clear_env(mp)
        cal_vars = jm.calibrate_int8(variables, [(lr, hr)], process_num=4)
    port = PatchRefinerPlus(slice_config(), device="cpu")
    load_jax_params(port, variables)
    return jm, cal_vars, port, lr, hr, variables


def _jax_int8(monkeypatch, jm, cal_vars, lr, hr, mode, perchan):
    """JAX's int8 depth: calibrated from ``cal_vars``, or dynamic (no
    ``quant_scales``) when ``cal_vars`` holds the plain variables."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("PRV2_INT8", "1")
    monkeypatch.setenv("PRV2_INT8_FORCE", "1")
    monkeypatch.setenv("PRV2_INT8_MIN_HW", str(MIN_HW))
    if perchan:
        monkeypatch.setenv("PRV2_INT8_PERCHAN", "1")
    type(jm)._jitted_infer.cache_clear()
    try:
        depth, _ = jm.infer(cal_vars, lr, hr, cai_mode=mode, process_num=4)
    finally:
        type(jm)._jitted_infer.cache_clear()
        _clear_env(monkeypatch)
    return np.asarray(depth, np.float64)


def test_calibration_matches_jax(both):
    """The port's ``calibrate_int8`` against JAX's on the same weights and
    frame: the abs-maxes within 1e-5 relative at the 12 sites the gates
    select, 2e-5 at the others, each plus 1e-6 of the site's abs-max (a
    channel far below the site's range carries the range's absolute float32
    error: measured 2.4e-5 relative on a channel at 1/200 of its site's
    range); ``kq`` and ``sw`` equal; ``swc`` within the abs-maxes' bar plus
    its two float32 roundings (it is a max of ``w * sx_c``: from JAX's
    abs-maxes the port's ``swc`` and ``kqc`` are equal to JAX's); ``kqc``
    equal at >= 99.9% of the weights
    and never off by more than 1. The abs-maxes differ because the exact
    layers before each site sum in another order; behind 30-odd MBConv
    blocks (the encoder's last stages, never selected at these shapes) the
    difference reached 1.09e-5. The gates select the 15 sites; at the
    three head sites the abs-maxes are by (pixel phase, channel) where the
    reference's are over space-to-depth channels (``s2d``), and held to the
    same bar."""
    _, cal_vars, port, lr, hr, variables = both
    port.set_int8(None)
    own = port.calibrate_int8([(lr, hr)], process_num=4, min_hw=MIN_HW)
    ref = load_jax_int8(port, cal_vars, min_hw=MIN_HW)
    assert sorted(own.sites) == sorted(ref.sites)
    assert sorted(own.selected()) == sorted(SITES_15)
    same, total, worst = 0, 0, [0.0, 0.0]
    for n, e in ref.sites.items():
        o = own.sites[n]
        tol = 1e-5 if n in SITES_15 else 2e-5
        atol = 1e-6 * float(e["amax"])
        np.testing.assert_allclose(o["amax"].numpy(), e["amax"].numpy(), rtol=tol, err_msg=n)
        np.testing.assert_allclose(o["amax_c"].numpy(), e["amax_c"].numpy(), rtol=tol, atol=atol,
                                   err_msg=n)
        np.testing.assert_array_equal(o["kq"].numpy(), e["kq"].numpy(), err_msg=n)
        np.testing.assert_array_equal(o["sw"].numpy(), e["sw"].numpy(), err_msg=n)
        np.testing.assert_allclose(o["swc"].numpy(), e["swc"].numpy(), rtol=tol + 2 ** -22, err_msg=n)
        da = float(np.max(np.abs(o["amax_c"].numpy() - e["amax_c"].numpy()) / float(e["amax"])))
        worst[n in SITES_15] = max(worst[n in SITES_15], da)
        d = np.abs(o["kqc"].numpy().astype(np.int32) - e["kqc"].numpy().astype(np.int32))
        assert d.max() <= 1, n
        same, total = same + int((d == 0).sum()), total + d.size
    print(f"abs-max diff / site abs-max: the 15 sites {worst[1]:.3g}, the others {worst[0]:.3g}; "
          f"kqc equal {same / total:.6f}")
    assert same >= 0.999 * total, same / total
    # the loader's entries, per phase at the head unit, are the port's own
    # fold of the carried abs-maxes (JAX calibrates under jit)
    from patchrefinerv2_torch.models.int8 import Int8Calibration, sites_of

    convs = sites_of(port.net)
    for n in SITES_15:
        e = ref.sites[n]
        mine = Int8Calibration.entry(convs[n].weight, e["amax_c"], layout=e["layout"])
        for key in ("kq", "sw", "kqc", "swc"):
            np.testing.assert_array_equal(mine[key].numpy(), e[key].numpy(), err_msg=f"{n} {key}")


@pytest.mark.parametrize("mode,scales", [("m1", "perchan"), ("m1", "tensor"), ("m2", "perchan")])
def test_int8_inference_matches_jax(monkeypatch, both, mode, scales):
    """The composed int8 run in float32 (forced), with the JAX calibration
    carried across by ``load_jax_int8``, against JAX's default int8 mode on
    the same calibration, at the 15 sites. Bar: mean rel < 2.5e-4 (rel to
    |JAX| floored at 1e-3) with per-channel scales, < 4e-4 with one scale per
    tensor. The maximum is not held to them: where a float32 difference
    upstream (the exact layers between the sites sum in another order)
    flips a rounding of ``x / sx``, the value moves by one int8 step, and
    the convolutions and upsamples downstream spread it; one scale per
    tensor is the coarser grid, so its steps are larger. With the 12 plain
    sites alone the bars were 1e-4 and 2e-4; the three head sites, whose
    int8 steps land next to the output, double the spread. Measured at 15 sites: m1
    perchan mean 1.46e-4 (max 1.0e-3), m1 tensor 2.29e-4 (2.0e-3), m2
    perchan 1.22e-4 (1.0e-3); the port's own int8 m1 moves as much when its
    frame is perturbed by 1e-7 relative: mean 1.31e-4 (perchan), 1.94e-4
    (tensor), against 5.0e-5 and 9.8e-5 with the head sites exact. Computing
    the dequant and bias as one fused multiply-add, as XLA's jit on the CPU
    does, moves the port no nearer (m1 perchan 1.47e-4). The int8 run must
    differ from the port's exact run by at least 4x that mean with
    per-channel scales (measured 8.3x m1, 10.8x m2), 2x with one scale per
    tensor (measured 3.6x), and with median rel < 0.05 (the int8 path ran,
    and stays near the exact one)."""
    jm, cal_vars, port, lr, hr, _ = both
    ref = _jax_int8(monkeypatch, jm, cal_vars, lr, hr, mode, scales == "perchan")
    port.set_int8(None)
    exact = port.infer(lr, hr, mode, process_num=4)[0].numpy().astype(np.float64)
    port.set_int8(load_jax_int8(port, cal_vars, min_hw=MIN_HW), scales, force=True)
    got = port.infer(lr, hr, mode, process_num=4)[0].numpy().astype(np.float64)
    port.set_int8(None)
    assert got.shape == ref.shape and np.isfinite(got).all()
    floor = np.maximum(np.abs(ref), 1e-3)
    rel = np.abs(got - ref) / floor
    off = np.abs(exact - ref) / floor
    print(f"{mode} {scales}: max rel {rel.max():.3g}, p99.9 {np.quantile(rel, 0.999):.3g}, "
          f"mean {rel.mean():.3g}, median {np.median(rel):.3g}; int8 vs exact mean {off.mean():.3g}, "
          f"median {np.median(off):.3g}")
    assert rel.mean() < (2.5e-4 if scales == "perchan" else 4e-4), rel.mean()
    assert off.mean() >= (4 if scales == "perchan" else 2) * rel.mean(), (off.mean(), rel.mean())
    assert 0 < np.median(off) < 0.05


def test_dtype_gate_and_stale_calibration(both):
    """As ``PRV2_INT8_FORCE`` is off in the reference: a float32 model with
    the mode set but not forced serves exactly. A calibration made in
    float32 is stale once the model infers in bfloat16: inference raises."""
    _, cal_vars, port, lr, hr, variables = both
    port.set_int8(None)
    exact = port.infer(lr, hr, "m1", process_num=4)[0]
    port.set_int8(load_jax_int8(port, cal_vars, min_hw=MIN_HW), "perchan", force=False)
    assert torch.equal(port.infer(lr, hr, "m1", process_num=4)[0], exact)
    with pytest.raises(ValueError):
        port.set_int8(None, "rowwise")
    port.set_infer_dtype(torch.bfloat16)
    try:
        with pytest.raises(RuntimeError, match="calibrat"):
            port.infer(lr, hr, "m1", process_num=4)
    finally:  # back to float32 and the float32 weights
        port.set_infer_dtype(torch.float32)
        port.set_int8(None)
        load_jax_params(port, variables)


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_dynamic_int8_inference_matches_jax(monkeypatch, both, mode):
    """The dynamic int8 mode (``set_int8(None, "dynamic")``: one activation
    scale per site and chunk from the input's live abs-max, the weights
    quantized per output channel when the mode is set) in float32 (forced)
    against JAX with ``PRV2_INT8=1`` and no ``quant_scales``, at the 15
    sites. The chunks are JAX's (4 patches in m1, m2's stream in chunks of
    4 with its last chunk padded by repeats): the scale of a site depends on
    the whole chunk. Bar: mean rel < 6e-4 (rel to |JAX| floored at 1e-3).
    One scale per tensor is the coarse grid, and each live abs-max carries
    the float32 difference of the exact layers before it, so a value moves
    by one int8 step where that flips a rounding. Measured: m1 mean 3.69e-4
    (max 2.3e-3), m2 3.11e-4; the port's own dynamic m1 moves by 3.24e-4
    mean when its frame is perturbed by 1e-7 relative. The int8 run must
    differ from the port's exact run by at least 1.5x that mean (measured
    2.3x m1, 2.6x m2: on these random weights the dynamic grid lies near
    the exact run, 8.4e-4), with median rel < 0.05."""
    jm, _, port, lr, hr, variables = both
    ref = _jax_int8(monkeypatch, jm, variables, lr, hr, mode, False)
    port.set_int8(None)
    exact = port.infer(lr, hr, mode, process_num=4)[0].numpy().astype(np.float64)
    port.set_int8(None, "dynamic", force=True, min_hw=MIN_HW)
    got = port.infer(lr, hr, mode, process_num=4)[0].numpy().astype(np.float64)
    port.set_int8(None)
    assert got.shape == ref.shape and np.isfinite(got).all()
    floor = np.maximum(np.abs(ref), 1e-3)
    rel = np.abs(got - ref) / floor
    off = np.abs(exact - ref) / floor
    print(f"{mode} dynamic: max rel {rel.max():.3g}, p99.9 {np.quantile(rel, 0.999):.3g}, "
          f"mean {rel.mean():.3g}, median {np.median(rel):.3g}; int8 vs exact mean {off.mean():.3g}, "
          f"median {np.median(off):.3g}")
    assert rel.mean() < 6e-4, rel.mean()
    assert off.mean() >= 1.5 * rel.mean(), (off.mean(), rel.mean())
    assert 0 < np.median(off) < 0.05


def test_dynamic_mode_gate_and_requantize(both):
    """The dynamic mode takes no calibration, applies to a float32 model only
    when forced (a float32 model with it set but not forced serves exactly),
    and quantizes the weights as they are when it is set and again after
    ``set_infer_dtype``."""
    from patchrefinerv2_torch.models.int8 import Served, sites_of
    from patchrefinerv2_torch.ops.quant import quantize_per_out_channel

    _, cal_vars, port, lr, hr, variables = both
    port.set_int8(None)
    exact = port.infer(lr, hr, "m1", process_num=4)[0]
    with pytest.raises(ValueError, match="no calibration"):
        port.set_int8(load_jax_int8(port, cal_vars, min_hw=MIN_HW), "dynamic")
    port.set_int8(None, "dynamic", min_hw=MIN_HW)
    assert torch.equal(port.infer(lr, hr, "m1", process_num=4)[0], exact)
    site = "refiner_fusion_model.c2f.scratch.output_conv1"
    conv = sites_of(port.net)[site]
    assert conv.int8 is None
    port.set_infer_dtype(torch.bfloat16)
    try:
        assert isinstance(conv.int8, Served) and conv.int8.dynamic
        kq, sw = quantize_per_out_channel(conv.weight)
        assert conv.weight.dtype == torch.bfloat16
        assert torch.equal(conv.int8.kq, kq) and torch.equal(conv.int8.scale, sw)
    finally:  # back to float32 and the float32 weights
        port.set_infer_dtype(torch.float32)
        port.set_int8(None)
        load_jax_params(port, variables)
