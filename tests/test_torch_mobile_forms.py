"""The fusion head's other forms on PatchRefinerV2-Mobile against the JAX
package: ``coarse2fine=False`` (no C2F: the fusion layers read the
refiner's own 6 levels and its depth;
``patchrefinerv2_zoedepth_ablation/plus_mobile_u4k_base_coarse.py``) and
the ``self-agg`` C2F (its GatedConvUnits without fusion conv;
``plus_mobile_c2f_selfagg.py``), each in m1 and m2; every config that
names a MobileNetV4 refiner building; and the forms the port does not have
raising: ``only-gate``, ``BiDirectionalFusionHeavy``, global attention and
the ConvNeXt refiners.

tests/test_torch_mobile.py's slice and weights (the JAX tree from
``jax.eval_shape`` of its init, leaves drawn with numpy), one model of
each form for the module; the bar is float32 max rel < 1e-4 and mean rel
< 1e-5. The kernel wrappers' calls in a chunk are counted and held to
``BiDirectionalFusion.kernel_calls``, the per-chunk launches that
``chip_smoke.py`` expects of K5 and K9 on the card.
"""

import glob
import os
import pathlib

import numpy as np
import pytest
import torch

from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models import patchrefinerplus as prp
from patchrefinerv2_torch.models.blocks import convs, dpt, fusion
from patchrefinerv2_torch.models.blocks.refiner import ENCODER_SPECS
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import build_both, frame, mobile_config
from tests.test_torch_modules import assert_same_tree
from tests.test_torch_slice import assert_rel

FORMS = {
    "no_c2f": dict(coarse2fine=False, fine_chl_after_coarse2fine=[32, 32, 32, 64, 96, 960]),
    "self_agg": dict(coarse2fine_type="self-agg"),
}


@pytest.fixture(scope="module", params=sorted(FORMS))
def form(request):
    return (request.param, *build_both(mobile_config(**FORMS[request.param])))


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_form_matches_jax(form, mode):
    name, jm, variables, port = form
    lr, hr = frame()
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    assert tuple(depth.shape) == (96, 128)
    assert float(np.std(np.asarray(depth_j))) > 0
    assert_rel(depth.numpy(), depth_j, f"{name} {mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"{name} {mode} coarse_pred")


def test_form_tree_and_kernel_calls(form, monkeypatch):
    """The port holds the JAX tree's modules and no more (``load_jax_params``
    checked both ways in the fixture): no ``c2f`` without coarse2fine, no
    fusion convs in self-agg. Without C2F the state dict converts back to
    the JAX tree; ``convert_bidirectional_fusion`` reads a fusion conv in
    every GatedConvUnit, so self-agg has no converter round trip. One chunk
    calls K5 and K9 as ``kernel_calls`` says: K5 never, K9 at 4 sites
    without C2F (the two level-0 fusion layers, the last f2r_agg conv and
    final_conv) and 8 in self-agg (the head's unit has no fusion conv)."""
    name, _, variables, port = form
    head = port.net.refiner_fusion_model
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    assert not any(".fusion_conv." in k for k in sd)
    if name == "no_c2f":
        assert head.c2f is None and not any(".c2f." in k for k in sd)
        assert_same_tree(convert_patchrefinerplus(sd), variables)
    calls = {"gate_tail": 0, "tail_conv": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for mod in (dpt, convs, fusion):
        if hasattr(mod, "gate_tail"):
            monkeypatch.setattr(mod, "gate_tail", counting("gate_tail", mod.gate_tail))
        monkeypatch.setattr(mod, "tail_conv", counting("tail_conv", mod.tail_conv))
    lr, hr = frame()
    port.infer(lr, hr, "m1", process_num=4)  # one chunk of 4 patches
    want = {"no_c2f": (0, 4), "self_agg": (0, 8)}[name]
    assert (calls["gate_tail"], calls["tail_conv"]) == want
    assert head.kernel_calls() == dict(zip(("gate_tail", "tail_conv"), want))


def test_flagship_kernel_calls():
    """The flagship's head: K5 at its 10 GatedConvUnits, K9 at its 9 sites."""
    cfg = Config.fromfile("configs/patchrefinerv2_zoedepth/v2_eff_u4k.py").model.config
    with torch.device("meta"):
        net = prp.PRPlusNet(cfg)
    assert net.refiner_fusion_model.kernel_calls() == {"gate_tail": 10, "tail_conv": 9}


# every PatchRefinerPlus config that names a MobileNetV4 refiner (the
# semi-supervised one is another model), and the two forms the port lacks
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
MOBILE_CONFIGS = sorted(f for f in glob.glob(os.path.join(CONFIGS, "**", "*.py"), recursive=True)
                        if "semi" not in f and "mobilenetv4" in pathlib.Path(f).read_text())
UNPORTED = {"plus_mobile_c2f_noenc.py": "only-gate", "plus_mobile_u4k_base_coarse_heavy.py":
            "BiDirectionalFusion"}


@pytest.mark.parametrize("path", MOBILE_CONFIGS, ids=os.path.basename)
def test_mobile_configs_build(path):
    """Each builds (on the meta device) with the encoder and widths its
    ``encoder_name`` names, or raises for ``only-gate`` and Heavy."""
    cfg = Config.fromfile(path).model.config
    match = UNPORTED.get(os.path.basename(path))
    if match:
        with pytest.raises(NotImplementedError, match=match):
            prp.PRPlusNet(cfg)
        return
    with torch.device("meta"):
        net = prp.PRPlusNet(cfg)
    fine = cfg.refiner.fine_branch
    enc = net.refiner_fine_branch.refiner_encoder
    assert enc.channels == ENCODER_SPECS[fine.encoder_name]["channels"]
    assert enc.conv_stem.in_channels == (4 if fine.get("coarse_condition", True) else 3)
    c2f = cfg.refiner.fusion_model.get("coarse2fine", True)
    assert (net.refiner_fusion_model.c2f is not None) == c2f


@pytest.mark.parametrize("fusion_model,match", [
    (dict(coarse2fine_type="only-gate"), "only-gate"),
    (dict(type="BiDirectionalFusionHeavy"), "BiDirectionalFusion"),
    (dict(glb_att=True), "global attention"),
])
def test_unported_forms_raise(fusion_model, match):
    cfg = mobile_config(**fusion_model)
    with pytest.raises(NotImplementedError, match=match):
        PatchRefinerPlus(cfg, device="cpu")


@pytest.mark.parametrize("encoder", ["convnextv2_large.fcmae_ft_in22k_in1k_384", "convnext_large",
                                     "mobilenetv3_large_100"])
def test_unported_refiners_raise(encoder):
    """ConvNeXt: the JAX package cannot build it either (4 levels where C2F
    unpacks 5), which the message says; MobileNetV3 is not ported."""
    cfg = mobile_config()
    cfg["refiner"]["fine_branch"]["encoder_name"] = encoder
    with pytest.raises(NotImplementedError, match="ConvNeXt" if "convnext" in encoder else "MobileNetV3"):
        PatchRefinerPlus(cfg, device="cpu")
