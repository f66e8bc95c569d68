"""The port's PatchRefiner V1 against the JAX package: FusionUnet alone, V1
with a ZoeDepth fine branch in m1, m2 and rN, a DA2 V1 in m1, the weights'
round trip, every V1 config building, and what raises (int8, a present
``pretrain_fine_model``). Its training: tests/test_torch_v1_train.py.

The ZoeDepth slice is tests/test_torch_slice.py's tiny BEiT ZoeDepth (4
blocks of width 64) as both the coarse and the fine branch, with FusionUnet
``temp_chl=[16, 32, 32, 32, 32, 32]``, ``dec_chl=[32, 32, 32, 32, 16]``, on
48x64 patches of a 96x128 frame split 2x2, ``process_num=4``; the DA2 one a
``vitt`` DA2 (tests/test_torch_da2.py) as both branches on 56x84 patches of
a 112x168 frame. The JAX variables come from ``jax.eval_shape`` of the JAX
model's ``init``, every leaf drawn with numpy from a seed, and are loaded
into the port through ``load_jax_params``; the images are numpy arrays from
a seed. The port runs on the CPU, so every kernel wrapper takes its plain
version.

Bar (float32): the depth maps and the coarse depth agree to max rel < 1e-4
and mean rel < 1e-5 (``assert_rel``, relative to each element floored at
1e-3). FusionUnet alone on random levels and depths is held to the same
bar relative to its output's magnitude: with ``update_base`` some of its
outputs lie within 1e-3 of the clamp at 0, where float32 sums in another
order differ by more than 1e-4 of the element (measured 3.0e-4 of one
element, 1.8e-7 of the magnitude).
"""

import glob
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.blocks.fusion import FusionUnet as JFusionUnet
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefiner

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models import patchrefinerplus as prp
from patchrefinerv2_torch.models.blocks import convs, fusion
from patchrefinerv2_torch.models.blocks.fusion import FusionUnet
from patchrefinerv2_torch.models.patchrefiner import PatchRefiner, build_model
from patchrefinerv2_torch.utils.checkpoint import apply_config_pretrained
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_eval import jax_random_starts
from tests.test_torch_mobile import frame, random_variables
from tests.test_torch_modules import assert_same_tree, nchw
from tests.test_torch_slice import assert_rel, slice_config

TEMP, DEC = [16, 32, 32, 32, 32, 32], [32, 32, 32, 32, 16]


def v1_config(base=None) -> dict:
    """``base`` (the ZoeDepth slice by default) with its coarse branch as the
    fine branch too and FusionUnet as the head."""
    cfg = base or slice_config()
    cfg["refiner"] = dict(fine_branch=dict(cfg["coarse_branch"]),
                          fusion_model=dict(type="FusionUnet", temp_chl=TEMP, dec_chl=DEC))
    return cfg


def build_v1(cfg, seed: int = 21):
    """The JAX PatchRefiner, its random variables and the port with them."""
    jm = MODELS.build(dict(type="PatchRefiner", config=cfg))
    variables = random_variables(jm.init, seed)
    port = PatchRefiner(cfg, device="cpu")
    load_jax_params(port, variables)
    return jm, variables, port


@pytest.fixture(scope="module")
def both():
    return build_v1(v1_config())


def pyramid(rng, chl, hw=(64, 96)):
    """NHWC maps of ``chl`` channels, highest resolution first, halving."""
    return [rng.randn(2, hw[0] >> i, hw[1] >> i, c).astype(np.float32) for i, c in enumerate(chl)]


@pytest.mark.parametrize("with_base", [True, False])
def test_fusion_unet_matches_jax(with_base):
    """FusionUnet alone at 6 levels of 64x96 down to 2x3, the depths at
    64x96: the port (its 4 full-resolution sites in tail form) against the
    JAX module, with ``update_base`` (the clamp) and without."""
    rng = np.random.RandomState(2)
    c, f = pyramid(rng, [8, 16, 16, 16, 16, 16]), pyramid(rng, [8, 24, 24, 24, 24, 24])
    p1, p2 = (rng.rand(2, 64, 96, 1).astype(np.float32) * 10 for _ in range(2))
    base = p1 if with_base else None
    jm = JFusionUnet(temp_chl=TEMP, dec_chl=DEC)
    args = [list(map(jnp.asarray, c)), list(map(jnp.asarray, f)), jnp.asarray(p1), jnp.asarray(p2)]
    v = random_variables(jm.init, 4, *args, None if base is None else jnp.asarray(base))
    ref = jax.jit(jm.apply)(v, *args, None if base is None else jnp.asarray(base))
    port = FusionUnet([a.shape[-1] + b.shape[-1] for a, b in zip(c, f)], TEMP, DEC)
    port = port.to(memory_format=torch.channels_last)
    load_jax_params(port, v, part="FusionUnet")
    with torch.no_grad():
        got = port([nchw(a) for a in c], [nchw(a) for a in f], nchw(p1), nchw(p2),
                   None if base is None else nchw(base))
    d, m = np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(ref)), np.abs(np.asarray(ref)).max()
    print(f"FusionUnet update_base={with_base}: max {d.max() / m:.3g}, mean {d.mean() / m:.3g}")
    assert d.max() < 1e-4 * m and d.mean() < 1e-5 * m, (d.max() / m, d.mean() / m)


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_v1_inference_matches_jax(both, mode):
    jm, variables, port = both
    lr, hr = frame()
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    assert tuple(depth.shape) == (96, 128)
    assert float(np.std(np.asarray(depth_j))) > 0  # a map, not a constant
    assert_rel(depth.numpy(), depth_j, f"V1 {mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"V1 {mode} coarse_pred")


def test_v1_rn_matches_jax_with_injected_starts(both):
    jm, variables, port = both
    lr, hr = frame()
    key = jax.random.PRNGKey(5)
    depth_j, _ = jm.infer(variables, lr, hr, cai_mode="r8", process_num=4, seed=key)
    starts = jax_random_starts(key, jm.tile_cfg, 4, 2)
    depth, _ = port.infer(lr, hr, "r8", process_num=4, random_starts=starts)
    assert tuple(depth.shape) == (96, 128)
    assert_rel(depth.numpy(), depth_j, "V1 r8 depth")


def test_da2_v1_m1_matches_jax():
    jm, variables, port = build_v1(v1_config(da2_slice_config()))
    rng = np.random.RandomState(11)
    lr = rng.rand(1, 56, 84, 3).astype(np.float32)
    hr = rng.rand(1, 112, 168, 3).astype(np.float32)
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode="m1", process_num=4)
    depth, coarse = port.infer(lr, hr, "m1", process_num=4)
    assert float(np.std(np.asarray(depth_j))) > 0
    assert_rel(depth.numpy(), depth_j, "DA2 V1 m1 depth")
    assert_rel(coarse.numpy(), coarse_j, "DA2 V1 m1 coarse_pred")
    sd = port.net.state_dict()
    assert any(k.startswith("refiner_fine_branch.pretrained.blocks.") for k in sd)
    assert any(k.startswith("refiner_fine_branch.depth_head.scratch.") for k in sd)


def test_v1_weights_round_trip(both):
    """convert_patchrefiner of the port's state dict is the JAX tree that was
    loaded: the fine ZoeDepth under ``refiner_fine_branch.core.core.`` and
    ``refiner_fine_branch.``, FusionUnet's ``encoder_layers_1/2``,
    ``decoder_layers`` and ``final_conv``."""
    _, variables, port = both
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    assert any(k.startswith("refiner_fine_branch.core.core.pretrained.model.blocks.") for k in sd)
    assert any(k.startswith("refiner_fusion_model.decoder_layers.4.conv.double_conv.") for k in sd)
    assert_same_tree(convert_patchrefiner(sd), variables)
    # the JAX ZoeFineBranch alone loads into the port's fine network alone
    fine = {"params": variables["params"]["fine"]}
    own = {k: v.clone() for k, v in port.net.refiner_fine_branch.state_dict().items()}
    load_jax_params(port.net.refiner_fine_branch, fine, part="ZoeFineBranch")
    assert all(torch.equal(v, own[k]) for k, v in port.net.refiner_fine_branch.state_dict().items())


def leaves(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("head", ["self_agg", "fusion_unet"])
def test_every_jax_leaf_is_loaded(head, both):
    """``load_jax_params`` sets every port parameter from one JAX leaf each
    (it raises on a port key without one) and reads every leaf of the JAX
    tree: the loader's state dict has as many tensors as the tree has
    leaves, and loading it changes every port tensor. The self-agg
    BiDirectionalFusion has no converter round trip
    (``convert_bidirectional_fusion`` reads a fusion conv in every unit),
    so this is what pins its load; FusionUnet's also round-trips above."""
    if head == "self_agg":
        from tests.test_torch_mobile import build_both, mobile_config

        _, variables, port = build_both(mobile_config(coarse2fine_type="self-agg"))
        tree = {"params": variables["params"]["fusion"]}
        module, part = port.net.refiner_fusion_model, "BiDirectionalFusion"
    else:
        _, variables, port = both
        tree = {"params": variables["params"]["fusion"]}
        module, part = port.net.refiner_fusion_model, "FusionUnet"
    sd = jax_to_state_dict(tree, part)
    assert len(sd) == leaves(tree) == len(module.state_dict())
    with torch.no_grad():
        for t in module.state_dict().values():
            t.fill_(float("nan"))
    load_jax_params(module, tree, part=part)
    assert all(bool(torch.isfinite(t).all()) for t in module.state_dict().values())
    whole = jax_to_state_dict(variables)
    assert len(whole) == leaves(variables["params"]) + leaves(variables.get("batch_stats", {}))


def test_fusion_unet_kernel_calls(both, monkeypatch):
    """One chunk calls K9 and K6 in FusionUnet as ``kernel_calls`` says:
    K9 at its 4 full-resolution sites, K6 at the other 10 SingleConvCNNLNs,
    K5 never."""
    head = both[2].net.refiner_fusion_model
    calls = {"tail_conv": 0, "layer_norm": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for mod in (convs, fusion):
        monkeypatch.setattr(mod, "tail_conv", counting("tail_conv", mod.tail_conv))
    monkeypatch.setattr(convs, "layer_norm", counting("layer_norm", convs.layer_norm))
    rng = np.random.RandomState(3)
    c, f = pyramid(rng, [32] * 6, (48, 64)), pyramid(rng, [32] * 6, (48, 64))
    p = nchw(rng.rand(2, 48, 64, 1).astype(np.float32))
    with torch.no_grad():
        head([nchw(a) for a in c], [nchw(a) for a in f], p, p, p)
    assert head.kernel_calls() == {"gate_tail": 0, "tail_conv": 4, "layer_norm": 10}
    assert calls == {"tail_conv": 4, "layer_norm": 10}


def test_depth_net_kernel_calls(both):
    """The coarse and the fine ZoeDepth and a DA2 network count their K3/K4,
    K6 and K8 launches from their modules."""
    net = both[2].net
    want = {"attention": 4, "layer_norm": 8, "attractor_update": 4, "log_binomial_depth": 1}
    assert net.coarse_branch.kernel_calls() == net.refiner_fine_branch.kernel_calls() == want
    da2 = prp.build_coarse_branch(da2_slice_config()["coarse_branch"], 1e-3, 80, (56, 84))
    assert da2.kernel_calls() == {"attention": 4, "layer_norm": 12, "attractor_update": 0,
                                  "log_binomial_depth": 0}


def test_v1_int8_and_other_heads_raise(both):
    port = both[2]
    for call in (lambda: port.set_int8(None, "dynamic"), lambda: port.calibrate_int8([])):
        with pytest.raises(NotImplementedError, match="fine depth network"):
            call()
    cfg = v1_config()
    cfg["refiner"]["fusion_model"]["type"] = "BiDirectionalFusion"
    with pytest.raises(NotImplementedError, match="FusionUnet"):
        PatchRefiner(cfg, device="cpu")
    cfg = v1_config()
    cfg["refiner"]["fine_branch"] = dict(type="LightWeightRefiner")
    with pytest.raises(NotImplementedError, match="ZoeDepth or DA2"):
        PatchRefiner(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="LightWeightRefiner"):
        prp.PatchRefinerPlus(v1_config(), device="cpu")  # V1's fine branch in a V2 model
    with pytest.raises(NotImplementedError, match="PatchFusion"):
        build_model({"type": "PatchFusion", "config": {}}, device="cpu")


def test_pretrain_fine_model_keeps_random_init_or_raises(both, tmp_path):
    """A missing ``pretrain_fine_model`` logs and keeps the random init, as
    the JAX package's ``apply_config_pretrained``; an existing one raises
    (a BaselinePretrain checkpoint)."""
    port = both[2]
    before = {k: v.clone() for k, v in port.net.state_dict().items()}
    port.config.update(pretrain_fine_model=str(tmp_path / "missing"))
    assert apply_config_pretrained(port) == {}
    assert all(torch.equal(v, before[k]) for k, v in port.net.state_dict().items())
    port.config.update(pretrain_fine_model=str(tmp_path))
    try:
        with pytest.raises(NotImplementedError, match="pretrain_fine_model.*BaselinePretrain"):
            apply_config_pretrained(port)
    finally:
        port.config.update(pretrain_fine_model=None)


CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
V1_CONFIGS = sorted(
    f for f in glob.glob(os.path.join(CONFIGS, "**", "*.py"), recursive=True)
    if "semi" not in f and Config.fromfile(f).get("model", {}).get("type") == "PatchRefiner")


def test_v1_configs_found():
    """The 15 configs that build a PatchRefiner (the semi-supervised ones
    build it as a student, which is another model)."""
    assert len(V1_CONFIGS) == 15, [os.path.basename(f) for f in V1_CONFIGS]


@pytest.mark.parametrize("path", V1_CONFIGS, ids=lambda p: pathlib.Path(p).parent.name + "/" +
                         os.path.basename(p))
def test_v1_configs_build(path):
    """Each builds on the meta device: both branches of its type at the
    config's patch shape, FusionUnet at its widths, its cat(coarse, fine)
    widths the config's ``input_chl``."""
    cfg = Config.fromfile(path).model.config
    with torch.device("meta"):
        net = prp.PRPlusNet(cfg, v1=True)
    fus = cfg.refiner.fusion_model
    head = net.refiner_fusion_model
    assert [m.single_conv[0].in_channels for m in head.encoder_layers_1] == list(fus.input_chl)
    assert [m.single_conv[0].out_channels for m in head.encoder_layers_2] == list(fus.temp_chl)
    assert [m.conv.double_conv[2].out_channels for m in head.decoder_layers] == list(fus.dec_chl)
    assert type(net.coarse_branch) is type(net.refiner_fine_branch)
    assert head.kernel_calls()["tail_conv"] == 4
