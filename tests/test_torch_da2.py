"""The port's Depth-Anything-V2 coarse path against the JAX package on the
CPU: the DINOv2 trunk (``vitt``), the DA2 model, and PatchRefinerPlus
tiled inference (m1, m2) with a ``vitt`` DA2 coarse branch, the
EfficientNet-B5 refiner and BiDirectionalFusion, on a 56x84 image and on a
50x84 one that the Depth-Anything resizer rounds to 56x84.

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
from patchrefinerv2_tpu.models.tiling import TileCfg as JTileCfg
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus

from patchrefinerv2_torch.models.backbones.dpt import DepthAnythingV2
from patchrefinerv2_torch.models.backbones.vit import DinoViT
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_eval import jax_random_starts
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
    """The DA2 network takes sides that are multiples of 14 and raises on
    others; PatchRefinerPlus's inference rounds them first, as the JAX
    package's does (the Depth-Anything resizer, ``patchrefinerplus.py:628-631``):
    a 50x84 ``image_lr`` goes to the coarse branch resized (bilinear, align
    corners) to 56x84. m1, m2 and r8 (process_num 4, JAX's random starts
    injected) against JAX's ``infer`` at the composed bars."""
    jm, variables, port, lr, hr = both
    lr50 = lr[:, :50]
    with pytest.raises(ValueError, match="multiples of 14"):
        port.net.coarse_branch(nchw(lr50))
    assert port.coarse_input_shape((50, 84)) == (56, 84) and port.patch_input_shape == (56, 84)
    key = jax.random.PRNGKey(5)
    starts = jax_random_starts(key, JTileCfg((112, 168), (2, 2), (56, 84)), 4, 2)
    for mode in ("m1", "m2", "r8"):
        depth_j, coarse_j = jm.infer(variables, lr50, hr, cai_mode=mode, process_num=4, seed=key)
        depth, coarse = port.infer(lr50, hr, mode, process_num=4,
                                   random_starts=starts if mode == "r8" else None)
        assert tuple(depth.shape) == (112, 168) and tuple(coarse.shape) == (1, 56, 84, 1)
        assert_rel(depth.numpy(), depth_j, f"{mode} depth, 50x84 image_lr")
        assert_rel(coarse.numpy(), coarse_j, f"{mode} coarse_pred, 50x84 image_lr")


def test_da2_coarse_map_must_match_the_patches(both):
    """The coarse depth's roi comes out at the coarse map's size, which the
    coarse-conditioned refiner concatenates to the patch: an ``image_lr``
    that does not come to the patches' size at the coarse branch cannot run,
    in the JAX package (a concatenation error) nor in the port (a
    ValueError before the patches run). This is the KITTI val loaders'
    384x512 (rounded to 378x518) with the DA2 configs' 448x448 patches;
    here 384x512 with 56x84 patches."""
    jm, variables, port, _, hr = both
    lr = np.random.RandomState(3).rand(1, 384, 512, 3).astype(np.float32)
    with pytest.raises(TypeError, match="concatenate"):
        jm.infer(variables, lr, hr, cai_mode="m1", process_num=4)
    with pytest.raises(ValueError, match=r"coarse map is \(378, 518\) but the patches \(56, 84\)"):
        port.infer(lr, hr, "m1", process_num=4)
