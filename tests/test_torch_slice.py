"""The port's flagship tiled inference (m1 and m2) against the JAX package.

The flagship tree of tests/test_flagship_mesh.py (ZoeDepth over a tiny
BEiT trunk) with the full EfficientNet-B5 refiner
(``tf_efficientnet_b5_ap``, ``fine_chl=[24, 40, 64, 176, 512]``) and the
BiDirectionalFusion head, at a 96x128 frame split 2x2 with
``process_num=4``. One JAX model is initialised for the module (its init
costs most of this file's time), its variables are redrawn with numpy
from a seed and loaded into the port through ``load_jax_params``; image
inputs are numpy arrays from a seed. The port runs on the CPU, so every
kernel wrapper takes its plain version.

Bar (float32): the depth maps and the coarse depth agree to max rel < 1e-4
and mean rel < 1e-5, relative to |JAX| floored at 1e-3 (the depth is
clamped at 0 and may be exactly 0 on both sides).
"""

import numpy as np
import pytest
import torch

import jax

from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus

from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests.test_torch_modules import assert_same_tree, randomize


def slice_config():
    return dict(
        e2e_training=False,
        pretrain_stage=False,
        image_raw_shape=[96, 128],
        patch_process_shape=[48, 64],
        patch_split_num=[2, 2],
        fusion_feat_level=6,
        min_depth=1e-3,
        max_depth=80,
        strategy_refiner_target="offset_coarse",
        coarse_branch=dict(
            type="ZoeDepth", n_bins=16, bin_embedding_dim=16, attractor_alpha=1000,
            attractor_kind="mean", attractor_type="inv",
            trunk=dict(embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3], features=32,
                       out_channels=[24, 32, 48, 48])),
        refiner=dict(
            fine_branch=dict(type="LightWeightRefiner", coarse_condition=True,
                             with_decoder=False, encoder_name="tf_efficientnet_b5_ap"),
            fusion_model=dict(
                type="BiDirectionalFusion", coarse2fine=True, coarse2fine_type="coarse-gated",
                coarse_chl=[32, 16, 16, 16, 16, 32], fine_chl=[24, 40, 64, 176, 512],
                fine_chl_after_coarse2fine=[32, 64, 64, 64, 64, 64],
                temp_chl=[32, 64, 64, 128, 256, 512], dec_chl=[512, 256, 128, 64, 32])),
        sigloss=dict(type="SILogLoss"),
        gmloss=dict(type="GradMatchLoss"),
    )


@pytest.fixture(scope="module")
def both():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=slice_config()))
    variables = randomize(jm.init(jax.random.PRNGKey(0)), seed=21)
    port = PatchRefinerPlus(slice_config(), device="cpu")
    load_jax_params(port, variables)
    rng = np.random.RandomState(11)
    lr = rng.rand(1, 48, 64, 3).astype(np.float32)
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    return jm, variables, port, lr, hr


def assert_rel(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)
    print(f"{what}: max rel {rel.max():.3g}, mean rel {rel.mean():.3g}")  # shown with pytest -s
    assert rel.max() < 1e-4 and rel.mean() < 1e-5, (what, rel.max(), rel.mean())


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_tiled_inference_matches_jax(both, mode):
    jm, variables, port, lr, hr = both
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    assert tuple(depth.shape) == (96, 128)
    assert float(np.std(np.asarray(depth_j))) > 0  # a map, not a constant
    assert_rel(depth.numpy(), depth_j, f"{mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"{mode} coarse_pred")


def test_weights_round_trip(both):
    """convert_patchrefinerplus(port state dict) is the JAX tree that was
    loaded: load_jax_params is the converter's inverse."""
    _, variables, port, _, _ = both
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    assert_same_tree(convert_patchrefinerplus(sd), variables)


def test_unported_modes_raise(both):
    _, _, port, lr, hr = both
    with pytest.raises(NotImplementedError):
        port.infer(lr, hr, "r8", process_num=4)
