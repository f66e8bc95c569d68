"""The port's int8 serving mode on PatchRefinerV2-Mobile against the JAX
package's default int8 mode: tests/test_torch_mobile.py's slice (the
MobileNetV4-small refiner, a tiny BEiT ZoeDepth coarse branch, 48x64
patches of a 96x128 frame split 2x2, ``process_num=4``) in float32 with
the int8 path forced, as tests/test_torch_quant_slice.py runs the
flagship's, and with its ``PRV2_INT8_MIN_HW`` of 128 (the default 8192
scaled by the slice's pixels).
"""

import numpy as np
import pytest

from patchrefinerv2_torch.utils.jax_weights import load_jax_int8
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import build_both, frame, mobile_config
from tests.test_torch_quant import SITES_15
from tests.test_torch_quant_slice import MIN_HW, _clear_env, _jax_int8


@pytest.fixture(scope="module")
def both():
    return build_both(mobile_config())


def test_mobile_int8_matches_jax(monkeypatch, both):
    """The int8 mode on the mobile slice (float32, forced) against JAX's
    default int8 mode, calibrated on the frame (m1 and the three shifted
    passes) on both sides: the same site names, the gates selecting the
    same 15 sites as on the flagship (the encoder's convolutions are no
    sites: the reference calls them directly), and m1 with per-channel
    scales carried across by ``load_jax_int8`` within
    tests/test_torch_quant_slice.py's bars: mean rel < 2.5e-4, at least 4x
    under the int8 run's distance from the exact one, whose median stays
    under 0.05."""
    jm, variables, port = both
    lr, hr = frame()
    with pytest.MonkeyPatch.context() as mp:
        _clear_env(mp)
        cal_vars = jm.calibrate_int8(variables, [(lr, hr)], process_num=4)
    ref_cal = load_jax_int8(port, cal_vars, min_hw=MIN_HW)
    port.set_int8(None)
    own = port.calibrate_int8([(lr, hr)], process_num=4, min_hw=MIN_HW)
    assert sorted(own.sites) == sorted(ref_cal.sites)
    assert sorted(own.selected()) == sorted(SITES_15)
    assert not any("refiner_fine_branch" in n for n in own.sites)
    ref = _jax_int8(monkeypatch, jm, cal_vars, lr, hr, "m1", True)
    exact = port.infer(lr, hr, "m1", process_num=4)[0].numpy().astype(np.float64)
    port.set_int8(ref_cal, "perchan", force=True)
    try:
        got = port.infer(lr, hr, "m1", process_num=4)[0].numpy().astype(np.float64)
    finally:
        port.set_int8(None)
    assert got.shape == ref.shape and np.isfinite(got).all()
    floor = np.maximum(np.abs(ref), 1e-3)
    rel, off = np.abs(got - ref) / floor, np.abs(exact - ref) / floor
    print(f"mobile m1 perchan: max rel {rel.max():.3g}, mean {rel.mean():.3g}; "
          f"int8 vs exact mean {off.mean():.3g}, median {np.median(off):.3g}")
    assert rel.mean() < 2.5e-4, rel.mean()
    assert off.mean() >= 4 * rel.mean(), (off.mean(), rel.mean())
    assert 0 < np.median(off) < 0.05
