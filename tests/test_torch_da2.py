"""The port's Depth-Anything-V2 coarse path against the JAX package on the
CPU: the DINOv2 trunk (``vitt``), the DA2 model, and PatchRefinerPlus
tiled inference (m1, m2) with a ``vitt`` DA2 coarse branch, the
EfficientNet-B5 refiner and BiDirectionalFusion.

JAX variables are redrawn with numpy from a seed and loaded through
``load_jax_params``; inputs are numpy arrays from a seed. The trunk sees a
56x84 input, a 4x6 patch grid, so the position embedding goes through the
bicubic interpolation with the DINO scale-factor quirk. Float32. Bars: the
modules atol 2e-4 / rtol 1e-4 (as tests/test_torch_modules.py); the
composed depth max rel < 1e-4 and mean rel < 1e-5 (as
tests/test_torch_slice.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.backbones.dpt import DepthAnythingV2 as JDA2
from patchrefinerv2_tpu.models.backbones.vit import DinoViT as JDino
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus

from patchrefinerv2_torch.models.backbones.dpt import DepthAnythingV2
from patchrefinerv2_torch.models.backbones.vit import DinoViT
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests.test_torch_modules import ATOL, RTOL, assert_close_nhwc, assert_same_tree, init_random, nchw
from tests.test_torch_slice import assert_rel


def da2_slice_config():
    return dict(
        e2e_training=False,
        pretrain_stage=False,
        image_raw_shape=[112, 168],
        patch_process_shape=[56, 84],
        patch_split_num=[2, 2],
        fusion_feat_level=6,
        min_depth=1e-3,
        max_depth=80,
        strategy_refiner_target="offset_coarse",
        coarse_branch=dict(type="DA2", model_cfg=dict(encoder="vitt", features=64)),
        refiner=dict(
            fine_branch=dict(type="LightWeightRefiner", coarse_condition=True,
                             with_decoder=False, encoder_name="tf_efficientnet_b5_ap"),
            fusion_model=dict(
                type="BiDirectionalFusion", coarse2fine=True, coarse2fine_type="coarse-gated",
                coarse_chl=[32, 64, 64, 64, 64, 64], fine_chl=[24, 40, 64, 176, 512],
                temp_chl=[32, 64, 64, 128, 256, 512], dec_chl=[512, 256, 128, 64, 32])),
        sigloss=dict(type="SILogLoss"),
        gmloss=dict(type="GradMatchLoss"),
    )


def _image(seed, h=56, w=84):
    return np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32)


def test_dino_vit_matches_jax():
    x = _image(0)
    jm = JDino(variant="vitt")
    v = init_random(jm, 1, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    port = DinoViT("vitt").eval()
    load_jax_params(port, v, part="DinoViT")
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == len(ref) == 4
    for i, ((tok, cls), (tok_j, cls_j)) in enumerate(zip(got, ref)):
        assert tuple(tok.shape) == (1, 24, 96)
        np.testing.assert_allclose(tok.numpy(), np.asarray(tok_j), rtol=RTOL, atol=ATOL, err_msg=f"tap {i}")
        np.testing.assert_allclose(cls.numpy(), np.asarray(cls_j), rtol=RTOL, atol=ATOL, err_msg=f"cls {i}")


def test_depth_anything_v2_matches_jax():
    x = _image(2)
    jm = JDA2(encoder="vitt", features=32, max_depth=20.0)
    v = init_random(jm, 3, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    port = DepthAnythingV2("vitt", 32, 20.0).eval()
    load_jax_params(port, v, part="DepthAnythingV2")
    with torch.no_grad():
        got = port(nchw(x))
    assert_close_nhwc(got["metric_depth"], ref["metric_depth"], "metric_depth")
    assert [f.shape[1] for f in got["coarse_features"]][::-1] == port.coarse_chl
    for i, (a, b) in enumerate(zip(got["coarse_features"], ref["coarse_features"])):
        assert_close_nhwc(a, b, f"pyramid level {i}")


@pytest.fixture(scope="module")
def both():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=da2_slice_config()))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    from tests.test_torch_modules import randomize

    variables = randomize(variables, seed=31)
    port = PatchRefinerPlus(da2_slice_config(), device="cpu")
    load_jax_params(port, variables)
    rng = np.random.RandomState(12)
    lr = rng.rand(1, 56, 84, 3).astype(np.float32)
    hr = rng.rand(1, 112, 168, 3).astype(np.float32)
    return jm, variables, port, lr, hr


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_da2_tiled_inference_matches_jax(both, mode):
    jm, variables, port, lr, hr = both
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    assert tuple(depth.shape) == (112, 168)
    assert float(np.std(np.asarray(depth_j))) > 0
    assert_rel(depth.numpy(), depth_j, f"{mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"{mode} coarse_pred")


def test_da2_weights_round_trip(both):
    """convert_patchrefinerplus (its DA2 branch, convert_da2) of the port's
    state dict is the JAX tree that was loaded."""
    _, variables, port, _, _ = both
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    assert_same_tree(convert_patchrefinerplus(sd), variables)


def test_da2_sides_not_multiple_of_14_raise(both):
    """The Depth-Anything resizer (rounding sides to multiples of 14) is not
    ported: such an input raises instead of running at another size."""
    _, _, port, lr, hr = both
    with pytest.raises(NotImplementedError, match="multiples of 14"):
        port.infer(lr[:, :50], hr, "m1", process_num=4)
