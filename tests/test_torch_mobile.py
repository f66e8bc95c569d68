"""The port's MobileNetV4 refiner against the JAX package: the encoders
alone at the three widths, and PatchRefinerV2-Mobile (``v2_mobile_u4k``'s
topology) in m1, m2 and rN and its weights' round trip (its int8 mode:
tests/test_torch_mobile_int8.py).

The slice is tests/test_torch_slice.py's (a tiny BEiT ZoeDepth coarse
branch, 48x64 patches of a 96x128 frame split 2x2, ``process_num=4``) with
the full MobileNetV4-small refiner (``fine_chl=[32, 32, 64, 96, 960]``).
The JAX variables come from ``jax.eval_shape`` of the JAX model's own
``init`` (its tree, without compiling the init), every leaf drawn with
numpy from a seed, and are loaded into the port through
``load_jax_params``; the images are numpy arrays from a seed. The port runs
on the CPU, so every kernel wrapper takes its plain version.

Bar (float32): the depth maps and the coarse depth agree to max rel < 1e-4
and mean rel < 1e-5 (``assert_rel``); the encoders' levels within
tests/test_torch_modules.py's atol 2e-4 and rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.backbones.mobilenetv4 import MobileNetV4Features as JMNV4
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus, convert_timm_mnv4

from patchrefinerv2_torch.models.backbones.mobilenetv4 import (
    MNV4_SPECS, MobileNetV4Features, unroll_spec,
)
from patchrefinerv2_torch.models.blocks.convs import to_nhwc
from patchrefinerv2_torch.models.blocks.refiner import ENCODER_SPECS, LightWeightRefiner
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_eval import jax_random_starts
from tests.test_torch_modules import assert_close_nhwc, assert_same_tree, nchw, randomize
from tests.test_torch_slice import assert_rel, slice_config

SMALL = "mobilenetv4_conv_small.e2400_r224_in1k"
NAMES = {"small": SMALL, "medium": "mobilenetv4_conv_medium.e500_r256_in1k",
         "large": "mobilenetv4_conv_large.e600_r384_in1k"}


def mobile_config(encoder: str = SMALL, **fusion):
    """The slice with a MobileNetV4 refiner, its fusion head updated by
    ``fusion``."""
    cfg = slice_config()
    cfg["refiner"]["fine_branch"]["encoder_name"] = encoder
    cfg["refiner"]["fusion_model"].update(encoder_name=encoder,
                                          fine_chl=ENCODER_SPECS[encoder]["channels"], **fusion)
    return cfg


def random_variables(init, seed: int, *args):
    """The variables tree that ``init(key, *args)`` makes, from
    ``jax.eval_shape`` (traced, not compiled), every leaf drawn with numpy
    by :func:`randomize`."""
    return randomize(jax.eval_shape(init, jax.random.PRNGKey(0), *args), seed)


def build_both(cfg, seed: int = 21):
    """The JAX model, its random variables and the port with the same weights."""
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=cfg))
    variables = random_variables(jm.init, seed)
    port = PatchRefinerPlus(cfg, device="cpu")
    load_jax_params(port, variables)
    return jm, variables, port


def frame():
    rng = np.random.RandomState(11)
    return rng.rand(1, 48, 64, 3).astype(np.float32), rng.rand(1, 96, 128, 3).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    return build_both(mobile_config())


@pytest.mark.parametrize("variant", ["small", "medium", "large"])
def test_mnv4_features_match_jax(variant):
    """Each width alone, with the 4-channel stem: its five levels against the
    JAX module's (the modules' atol and rtol, and the slice's bar, max
    < 1e-4 and mean < 1e-5, relative to the level's magnitude: measured
    <= 7.4e-7 and 9.1e-8; relative to each element floored at 1e-3, as the
    depth maps are held, the max reaches 8.5e-4 where a residual sum of
    values ~10 cancels to near 0), its widths the encoder table's; the timm
    state dict converts back to the JAX tree (``convert_timm_mnv4``), and
    the spec the converter derives from it builds the same module
    (``spec``), also through ``LightWeightRefiner(encoder_spec=...)``."""
    x = np.random.RandomState(0).rand(2, 32, 64, 4).astype(np.float32)
    jm = JMNV4(variant=variant, in_ch=4)
    v = random_variables(jm.init, 3, jnp.asarray(x))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = MobileNetV4Features(variant, in_ch=4).eval()
    load_jax_params(port, v, part="MobileNetV4Features")
    with torch.no_grad():
        got = port(nchw(x))
    assert port.channels == ENCODER_SPECS[NAMES[variant]]["channels"]
    assert [g.shape[1] for g in got] == port.channels
    assert [g.shape[2] for g in got] == [16, 8, 4, 2, 1]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert_close_nhwc(a, b, f"{variant} level {i}")
        d, m = np.abs(to_nhwc(a).numpy() - np.asarray(b)), np.abs(np.asarray(b)).max()
        assert d.max() < 1e-4 * m and d.mean() < 1e-5 * m, (variant, i, d.max() / m, d.mean() / m)
    sd = {k: t.numpy() for k, t in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    tree, spec = convert_timm_mnv4(sd, return_spec=True)
    assert_same_tree(tree, v)
    assert spec == unroll_spec(MNV4_SPECS[variant])
    again = MobileNetV4Features(in_ch=4, spec=spec)
    assert sorted(again.state_dict()) == sorted(port.state_dict())
    refiner = LightWeightRefiner(NAMES[variant], encoder_spec=spec)
    assert refiner.channels == port.channels and refiner.top_channels == port.channels[0]


@pytest.mark.parametrize("kind,jargs,pargs", [
    ("UIB", dict(out_ch=48, expand=3.0, stride=2, dw_start=5, dw_mid=5), (32, 48, 3.0, 2, 5, 5)),
    ("UIB", dict(out_ch=32, expand=2.0, stride=1, dw_start=3, dw_mid=0), (32, 32, 2.0, 1, 3, 0)),
    ("UIB", dict(out_ch=32, expand=4.0, stride=1, dw_start=0, dw_mid=0), (32, 32, 4.0, 1, 0, 0)),
    ("EdgeResidual", dict(out_ch=48, expand=4.0, kernel=3, stride=2), (32, 48, 4.0, 3, 2)),
    ("ConvBN", dict(out_ch=40, kernel=1, stride=1), (32, 40, 1, 1)),
])
def test_mnv4_blocks_match_jax(kind, jargs, pargs):
    """Each block alone (the stride on ``dw_mid``, or on ``dw_start`` without
    one; the residual at stride 1), through its own ``load_jax_params`` part."""
    import patchrefinerv2_tpu.models.backbones.mobilenetv4 as J
    import patchrefinerv2_torch.models.backbones.mobilenetv4 as P

    x = np.random.RandomState(1).randn(2, 16, 24, 32).astype(np.float32)
    jm = getattr(J, kind)(**jargs)
    v = random_variables(jm.init, 4, jnp.asarray(x))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = getattr(P, "ConvBnAct" if kind == "ConvBN" else kind)(*pargs).eval()
    load_jax_params(port, v, part=kind)
    with torch.no_grad():
        assert_close_nhwc(port(nchw(x)), ref, kind)


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_mobile_inference_matches_jax(both, mode):
    jm, variables, port = both
    lr, hr = frame()
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    assert tuple(depth.shape) == (96, 128)
    assert float(np.std(np.asarray(depth_j))) > 0  # a map, not a constant
    assert_rel(depth.numpy(), depth_j, f"mobile {mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"mobile {mode} coarse_pred")


def test_mobile_rn_matches_jax_with_injected_starts(both):
    jm, variables, port = both
    lr, hr = frame()
    key = jax.random.PRNGKey(5)
    depth_j, _ = jm.infer(variables, lr, hr, cai_mode="r8", process_num=4, seed=key)
    starts = jax_random_starts(key, jm.tile_cfg, 4, 2)
    depth, _ = port.infer(lr, hr, "r8", process_num=4, random_starts=starts)
    assert tuple(depth.shape) == (96, 128)
    assert_rel(depth.numpy(), depth_j, "mobile r8 depth")


def test_mobile_weights_round_trip(both):
    """convert_patchrefinerplus of the port's state dict is the JAX tree that
    was loaded, the MobileNetV4 encoder told from B5 by its keys."""
    _, variables, port = both
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    assert any(".pw_exp.conv." in k for k in sd)
    assert_same_tree(convert_patchrefinerplus(sd), variables)
