"""The port's BaselinePretrain (stage 1: one depth network trained alone, and
its tiled inference) against the JAX package on the CPU, and the hand-off
of its checkpoints into the later stages.

The networks are tests/test_torch_slice.py's tiny ZoeDepth (a 4-block BEiT
of width 64, 16 bins) at 48x64 patches of a 96x128 frame split 2x2, and
tests/test_torch_da2.py's ``vitt`` Depth-Anything-V2: as a coarse target
trained on 56x84 images (a 4x6 patch grid, so the DINOv2 position
embedding is resized bicubically and, under grad, goes through the bicubic
K2 backward) and inferring on 48x64 ones, which it rounds to 42x70; and as
a fine target over 48x64 patches (rounded likewise, its depth resized back
to 48x64). One JAX model a case,
its variables from ``jax.eval_shape`` of its init with every leaf drawn
with numpy, loaded into the port through ``load_jax_params(...,
part="DepthNet")``; inputs from numpy seeds.

Bars:

- a training step, float32: each loss max rel <= 1e-5; the depth max rel
  < 1e-4 and mean < 1e-5; each gradient leaf ||port - JAX|| / ||JAX|| <=
  1e-4, a leaf's norm floored at 1e-6 of the whole gradient's (the per-leaf
  bar of tests/test_torch_train_slice.py, which this network, without
  BatchNorm, meets in float32);
- inference (m1, m2, and rN with JAX's random starts injected): depth max
  rel < 1e-4 and mean < 1e-5 (tests/test_torch_slice.py);
- the bicubic K2 backward: the transpose of the forward's taps, equal to
  autograd through the plain version (float64, 1e-12) and to JAX's
  gradient of its bicubic resize with the DINOv2 scale factors (float32,
  1e-6 of the magnitude);
- the hand-off, bit for bit: a port stage-1 checkpoint through
  ``pretrain_coarse_model`` into PatchRefinerPlus equals what the JAX
  package's ``apply_config_pretrained`` makes of the same weights; through
  ``pretrain_fine_model`` into V1's fine depth network, where the JAX
  package takes nothing (pinned); into a Semi model's student and teacher.

Also pinned on the JAX side: its validation and ``Tester`` cannot run
BaselinePretrain (they pass ``mesh=`` to an ``infer`` that takes none),
while the port's do; neither side reads the branch's own ``pretrained``
key. Then all 11 BaselinePretrain configs build, and the CLI trains stage 1,
evaluates its checkpoint and hands it to a stage-3 config.
"""

import glob
import json
import os
import pathlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.evaluation.tester import Tester as JTester
from patchrefinerv2_tpu.models.tiling import TileCfg as JTileCfg
from patchrefinerv2_tpu.ops.resize import resize as j_resize
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.training.trainer import Trainer as JTrainer
from patchrefinerv2_tpu.utils.checkpoint import apply_config_pretrained as j_apply_config_pretrained
from patchrefinerv2_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from patchrefinerv2_tpu.utils.torch_convert import convert_zoedepth

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.evaluation.tester import Tester as PortTester
from patchrefinerv2_torch.models import baseline_pretrain as bp
from patchrefinerv2_torch.models.baseline_pretrain import BaselinePretrain
from patchrefinerv2_torch.models.patchrefiner import PatchRefiner, build_model
from patchrefinerv2_torch.models.patchrefiner_semi import PatchRefinerSemi
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.ops.resize import resize, resize_plain, resize_transpose
from patchrefinerv2_torch.test import main as evaluate_main
from patchrefinerv2_torch.train import build_dataset, main as train_main
from patchrefinerv2_torch.training.trainer import Trainer
from patchrefinerv2_torch.utils.checkpoint import (
    apply_config_pretrained, load_checkpoint, save_checkpoint,
)
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_eval import jax_random_starts
from tests.test_torch_mobile import mobile_config, random_variables
from tests.test_torch_modules import assert_same_tree
from tests.test_torch_semi import SSI_DA, semi_config
from tests.test_torch_slice import assert_rel, slice_config
from tests.test_torch_v1 import v1_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
ZOE = slice_config()["coarse_branch"]
DA2 = da2_slice_config()["coarse_branch"]
RAW, SPLIT = (96, 128), (2, 2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test (checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def baseline_config(target: str, branch: dict, patch=(48, 64)) -> dict:
    return dict(type="BaselinePretrain", target=target, min_depth=1e-3, max_depth=80,
                image_raw_shape=list(RAW), patch_process_shape=list(patch),
                patch_split_num=list(SPLIT), coarse_branch=branch if target == "coarse" else None,
                fine_branch=branch if target == "fine" else None, sigloss=dict(type="SILogLoss"))


CASES = {"zoe_coarse": baseline_config("coarse", ZOE), "zoe_fine": baseline_config("fine", ZOE),
         "da2_coarse": baseline_config("coarse", DA2, (56, 84)), "da2_fine": baseline_config("fine", DA2)}


@pytest.fixture(scope="module")
def models():
    """``models(case)``: (the JAX model, its random variables, the port with
    them), built once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = MODELS.build(dict(CASES[name]))
            variables = random_variables(jm.init, 21)
            port = BaselinePretrain(CASES[name], device="cpu")
            load_jax_params(port.net.branch, variables, part="DepthNet")
            cache[name] = jm, variables, port
        return cache[name]

    return get


def make_batch(target: str, hw=(48, 64), seed: int = 5) -> dict:
    """Two ``hw`` images with their 96x128 depth (coarse), or two ``hw``
    crops with their 72x96 depth (fine)."""
    rng = np.random.RandomState(seed)
    image = rng.rand(2, *hw, 3)
    if target == "coarse":
        return dict(image_lr=image, depth_gt=1.0 + 20.0 * rng.rand(2, *RAW, 1))
    return dict(crops_image_hr=image, crop_depths=1.0 + 20.0 * rng.rand(2, 72, 96, 1))


def frame(seed: int = 11):
    rng = np.random.RandomState(seed)
    return rng.rand(1, 48, 64, 3).astype(np.float32), rng.rand(1, *RAW, 3).astype(np.float32)


def jax_step(jm, variables, batch):
    """(loss dict, depth, gradients under the port's names) of JAX's loss, float32."""
    b = {k: jnp.asarray(np.asarray(x, np.float32)) for k, x in batch.items()}

    def loss(p):
        ld, aux = jm.loss({"params": p}, b)
        return ld["total_loss"], (ld, aux["depth_pred"])

    (_, (ld, depth)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return ({k: float(x) for k, x in ld.items()}, np.asarray(depth),
            jax_to_state_dict({"params": jax.device_get(grads)}, "DepthNet"))


# ------------------------------------------------------------- the training step
@pytest.mark.parametrize("name", ["zoe_coarse", "zoe_fine", "da2_coarse"])
def test_step_matches_jax(models, name):
    jm, variables, port = models(name)
    target = CASES[name]["target"]
    # DA2 at its 56x84 patch size: a 48x64 image rounded to 42x70 (3x5
    # patches) makes the float32 step ill-conditioned (8e-4 of a leaf on
    # both sides' float32 runs, 4e-7 in float64)
    batch = make_batch(target, (56, 84) if name == "da2_coarse" else (48, 64))
    ref_losses, ref_depth, ref = jax_step(jm, variables, batch)
    port.train()
    for p in port.net.parameters():
        p.grad = None
    ld, aux = port.loss(batch, update_stats=True)
    ld["total_loss"].backward()
    port.eval()
    losses = {k: float(v.detach()) for k, v in ld.items()}
    assert sorted(losses) == sorted(ref_losses) == sorted([f"{target}_loss", "total_loss"])
    for k in ref_losses:
        assert abs(losses[k] - ref_losses[k]) <= 1e-5 * abs(ref_losses[k]), (k, losses, ref_losses)
    assert_rel(aux["depth_pred"].detach().numpy(), ref_depth, f"{name} training depth")
    errs = {}
    for k, p in port.net.branch.named_parameters():
        assert p.grad is not None, k
        errs[k] = (np.linalg.norm(p.grad.double().numpy() - ref[k]), np.linalg.norm(ref[k]))
    assert sorted(errs) == sorted(ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print(f"{name}: worst gradient leaf", worst, errs[worst])  # shown with pytest -s
    for k, (d, n) in errs.items():
        assert d <= 1e-4 * max(n, 1e-6 * total), (k, d, n)
    if name == "da2_coarse":  # a 4x6 grid of the 37x37 table
        assert tuple(aux["depth_pred"].shape) == (2, 56, 84, 1)
        assert errs["pretrained.pos_embed"][1] > 1e-6 * total


# ------------------------------------------------------------------ inference
@pytest.mark.parametrize("name,mode", [("zoe_fine", "m1"), ("zoe_fine", "m2"), ("zoe_coarse", "m1"),
                                       ("da2_fine", "m1"), ("da2_coarse", "m1")])
def test_infer_matches_jax(models, name, mode):
    """The fine target's tiled depth on the 96x128 reensemble canvas (DA2:
    42x70 patch depths resized to 48x64 before the blend); the coarse
    target's depth at its (rounded) input size, the same in m2."""
    jm, variables, port = models(name)
    lr, hr = frame()
    ref, ref_coarse = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    assert float(np.std(np.asarray(ref))) > 0
    assert_rel(depth.numpy(), ref, f"{name} {mode} depth")
    if CASES[name]["target"] == "fine":
        assert coarse is None and ref_coarse is None and tuple(depth.shape) == RAW
    else:
        assert tuple(depth.shape) == ((42, 70) if name == "da2_coarse" else (48, 64))
        assert_rel(coarse.numpy(), ref_coarse, f"{name} depth NHWC")
        assert torch.equal(port.infer(lr, hr, "m2", process_num=4)[0], depth)


def test_rn_runs_n_iterations_of_jax_starts(models):
    """r3 with ``process_num`` 2: the m2 passes (4 + 2 + 2 + 1 patches, the
    odd pass padded: 5 chunks of 2), then 3 random chunks of 2 patches at
    JAX's starts (N iterations, not N // process_num); a generator draws
    them alike; starts of another shape raise."""
    jm, variables, port = models("zoe_fine")
    lr, hr = frame()
    key = jax.random.PRNGKey(3)
    starts = jax_random_starts(key, JTileCfg(RAW, SPLIT, (48, 64)), 2, 3)
    ref, _ = jm.infer(variables, lr, hr, cai_mode="r3", process_num=2, seed=key)
    batches = []
    hook = port.net.register_forward_hook(lambda m, i, o: batches.append(i[0].shape[0]))
    try:
        depth, _ = port.infer(lr, hr, "r3", process_num=2, random_starts=starts)
        assert batches == [2] * 8
        drawn, _ = port.infer(lr, hr, "r3", process_num=2, generator=torch.Generator().manual_seed(1))
    finally:
        hook.remove()
    assert tuple(depth.shape) == tuple(drawn.shape) == RAW and bool(torch.isfinite(drawn).all())
    assert_rel(depth.numpy(), ref, "r3 depth")
    with pytest.raises(ValueError, match=r"\(3, 2, 2\)"):
        port.infer(lr, hr, "r3", process_num=2, random_starts=starts[:1])
    with pytest.raises(NotImplementedError):
        port.infer(lr, hr, "m3", process_num=2)


# ------------------------------------------------------- the bicubic K2 backward
BICUBIC = [((1, 37, 37, 8), (32, 32), (32.1 / 37, 32.1 / 37)),  # DA2's 448x448 grid
           ((2, 37, 37, 3), (3, 5), (3.1 / 37, 5.1 / 37)),  # the tests' 3x5 grid
           ((1, 4, 6, 2), (9, 7), None)]


@pytest.mark.parametrize("shape,size,scale", BICUBIC)
def test_bicubic_backward_is_the_transpose(shape, size, scale):
    """Autograd through ``resize(..., "bicubic")`` gives the transpose of its
    four taps an axis: equal to autograd through the plain version in
    float64, and to JAX's gradient of its bicubic resize in float32."""
    rng = np.random.RandomState(7)
    x64 = torch.from_numpy(rng.randn(*shape)).requires_grad_(True)
    gy = rng.randn(shape[0], *size, shape[3])
    (g,) = torch.autograd.grad(resize(x64, size, "bicubic", False, scale), x64, torch.from_numpy(gy))
    (gp,) = torch.autograd.grad(resize_plain(x64, size, "bicubic", False, scale), x64,
                                torch.from_numpy(gy))
    np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        resize_transpose(torch.from_numpy(gy), shape[1:3], "bicubic", False, scale).numpy(), g.numpy())
    x32 = x64.detach().float().requires_grad_(True)
    (g32,) = torch.autograd.grad(resize(x32, size, "bicubic", False, scale), x32,
                                 torch.from_numpy(gy.astype(np.float32)))
    _, vjp = jax.vjp(lambda t: j_resize(t, size, "bicubic", False, scale_override=scale),
                     jnp.asarray(x64.detach().numpy(), jnp.float32))
    (gj,) = vjp(jnp.asarray(gy, jnp.float32))
    gj = np.asarray(gj)
    np.testing.assert_allclose(g32.numpy(), gj, rtol=0, atol=1e-6 * np.abs(gj).max())


def test_other_modes_keep_their_rule_under_grad():
    """Bilinear keeps aten's backward; nearest still raises."""
    x = torch.rand(1, 4, 4, 2, requires_grad=True)
    resize(x, (7, 5), "bilinear", True).sum().backward()
    assert x.grad is not None
    with pytest.raises(NotImplementedError, match="nearest"):
        resize(x, (8, 8), "nearest")


# ----------------------------------------------------------------- the configs
BASELINE_CONFIGS = sorted(
    f for f in glob.glob(str(ROOT / "configs" / "**" / "*.py"), recursive=True)
    if Config.fromfile(f).get("model", {}).get("type") == "BaselinePretrain")


def test_baseline_configs_found():
    """11 configs: 7 ZoeDepth coarse, 2 ZoeDepth fine, 2 DA2 coarse."""
    kinds = []
    for f in BASELINE_CONFIGS:
        m = Config.fromfile(f).model
        kinds.append((m.target, m[f"{m.target}_branch"].type))
    assert len(kinds) == 11
    assert sorted(set(kinds)) == [("coarse", "DA2"), ("coarse", "ZoeDepth"), ("fine", "ZoeDepth")]
    assert [kinds.count(k) for k in (("coarse", "ZoeDepth"), ("fine", "ZoeDepth"),
                                     ("coarse", "DA2"))] == [7, 2, 2]


@pytest.mark.parametrize("path", BASELINE_CONFIGS, ids=lambda p: pathlib.Path(p).parent.name + "/" +
                         os.path.basename(p))
def test_baseline_configs_build(path, monkeypatch):
    """Each builds on the meta device (no random init there) through
    ``build_model``: the target's network under ``coarse_branch.`` or
    ``fine_branch.``, BEiT-L ZoeDepth at 384x512 or DINOv2-L DA2 at 448x448;
    a DA2 input of 384x512 (``coarse_pretrain_kitti.py``'s validation)
    rounds to 378x518."""
    monkeypatch.setattr(bp, "init_random_", lambda net, generator: net)
    m = Config.fromfile(path).model
    with torch.device("meta"):
        model = build_model(m, device="meta")
    assert isinstance(model, BaselinePretrain) and model.target == m.target
    names = [n for n, _ in model.net.named_parameters()]
    assert names and all(n.startswith(f"{m.target}_branch.") for n in names)
    branch = m[f"{m.target}_branch"]
    assert type(model.net.branch).__name__ == {"ZoeDepth": "ZoeDepthBEiT",
                                                "DA2": "DepthAnythingV2"}[branch.type]
    count = sum(p.numel() for p in model.net.parameters())
    if branch.type == "DA2":
        assert model.patch_input_shape == (448, 448) and count == 334134465
        assert model.input_shape((384, 512)) == (378, 518)
    else:
        assert model.patch_input_shape == (384, 512) and count == 342898306
        assert model.net.branch.core.core.grid == (24, 32)


def test_weights_round_trip(models):
    """``convert_zoedepth`` of the port's state dict is the JAX tree that was
    loaded: ``load_jax_params(..., "DepthNet")`` is its inverse, with the
    reference's ``coarse_branch.`` names."""
    _, variables, port = models("zoe_coarse")
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    assert all(k.startswith("coarse_branch.") for k in sd)
    assert_same_tree(convert_zoedepth(sd, "coarse_branch."), variables["params"])


# ----------------------------------------------------------------- the hand-off
@pytest.fixture(scope="module")
def stage1(models, tmp_path_factory):
    """Stage-1 checkpoints of the same weights: the port's coarse and fine
    targets (``Trainer``'s format) and the JAX package's orbax one; the
    weights as the port's names without a prefix."""
    tmp = tmp_path_factory.mktemp("stage1")
    paths = {}
    for target in ("coarse", "fine"):
        port = models(f"zoe_{target}")[2]
        paths[target] = str(tmp / f"{target}_checkpoint_01")
        save_checkpoint(paths[target], {"state_dict": port.net.state_dict(), "epoch": 1, "step": 1})
    variables = models("zoe_coarse")[1]  # the fine target's are the same draws
    paths["jax"] = str(tmp / "jax_stage1")
    j_save_checkpoint(paths["jax"], {"params": variables["params"]})
    yield paths, jax_to_state_dict(variables, "DepthNet")
    shutil.rmtree(tmp, ignore_errors=True)


def test_pretrain_coarse_model_matches_jax(stage1):
    """PatchRefinerPlus (the slice with the MobileNetV4-small refiner) with
    ``pretrain_coarse_model``: the port's coarse
    branch takes every tensor of the stage-1 network and the rest keeps its
    weights, equal bit for bit to the JAX package's merge under
    ``params/coarse``."""
    paths, net = stage1
    jm = MODELS.build(dict(type="PatchRefinerPlus",
                           config=dict(mobile_config(), pretrain_coarse_model=paths["jax"])))
    variables = random_variables(jm.init, 22)
    want = jax_to_state_dict(j_apply_config_pretrained(jm, variables))
    port = PatchRefinerPlus(dict(mobile_config(), pretrain_coarse_model=paths["coarse"]), device="cpu")
    load_jax_params(port, variables)
    report = apply_config_pretrained(port)
    assert report["pretrain_coarse_model"]["taken"] == len(net)
    got = {k: v for k, v in port.net.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    for k, v in net.items():
        np.testing.assert_array_equal(got["coarse_branch." + k].numpy(), v, err_msg=k)


def test_pretrain_fine_model_follows_the_reference(stage1):
    """V1 as ``pr_cs.py`` configures it, both keys on one coarse stage-1
    checkpoint: the port loads it into the coarse branch and into the fine
    depth network (``refiner_fine_branch.``). The JAX package merges the
    checkpoint into ``params/fine``, whose network sits under ``inner``:
    its fine network keeps its weights (pinned), the rest is the port's."""
    paths, net = stage1
    jcfg = v1_config()
    jcfg.update(pretrain_coarse_model=paths["jax"], pretrain_fine_model=paths["jax"])
    jm = MODELS.build(dict(type="PatchRefiner", config=jcfg))
    variables = random_variables(jm.init, 23)
    out = j_apply_config_pretrained(jm, variables)
    assert_same_tree(out["params"]["fine"], variables["params"]["fine"])
    want = jax_to_state_dict(out)
    cfg = v1_config()
    cfg.update(pretrain_coarse_model=paths["coarse"], pretrain_fine_model=paths["coarse"])
    port = PatchRefiner(cfg, device="cpu")
    load_jax_params(port, variables)
    report = apply_config_pretrained(port)
    assert report["pretrain_coarse_model"]["taken"] == report["pretrain_fine_model"]["taken"] == len(net)
    got = {k: v for k, v in port.net.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    fine = "refiner_fine_branch."
    for k, v in got.items():
        ref = net[k[len(fine):]] if k.startswith(fine) else want[k]
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
    assert any(not np.array_equal(want[k], net[k[len(fine):]]) for k in got if k.startswith(fine))


def test_stage1_into_semi_student_and_teacher(stage1):
    """A fine-target checkpoint (``fine_branch.`` tensors) through the
    student's and the teacher's ``pretrain_coarse_model``."""
    paths, net = stage1
    sub = dict(type="PatchRefinerPlus",
               config=dict(slice_config(), pretrain_coarse_model=paths["fine"]))
    semi = PatchRefinerSemi(semi_config(sub, True, SSI_DA), device="cpu")
    report = apply_config_pretrained(semi)
    for who in ("student", "teacher"):
        assert report[f"{who}.pretrain_coarse_model"]["taken"] == len(net)
        sd = getattr(semi, who).net.state_dict()
        for k, v in net.items():
            np.testing.assert_array_equal(sd["coarse_branch." + k].numpy(), v, err_msg=k)


# ------------------------------------------------------- the JAX package's defects
def test_jax_cannot_validate_or_test_baseline_pretrain(models, tmp_path):
    """The JAX ``Trainer``'s default validation and its ``Tester`` pass
    ``mesh=`` to ``BaselinePretrain.infer``, which takes none: both raise.
    The port's validation and ``Tester.run`` give finite metrics (the coarse
    target's 48x64 depth resized to the 96x128 ground truth)."""
    jm, variables, port = models("zoe_coarse")
    ds = SyntheticDataset(mode="infer", length=1, image_raw_shape=RAW, network_process_size=(48, 64),
                          patch_raw_shape=(48, 64))
    loader = DataLoader(ds, batch_size=1)
    batch = next(iter(loader))
    evaluate = JTrainer._default_val_evaluator(SimpleNamespace(config={}, val_loader=loader, mesh=None))
    with pytest.raises(TypeError, match="mesh"):
        evaluate(jm, variables, batch)
    with pytest.raises(TypeError, match="mesh"):
        JTester({}, jm, loader, work_dir=str(tmp_path / "jax")).run(variables)
    evaluate = Trainer._default_val_evaluator(SimpleNamespace(config={}, val_loader=loader))
    metrics, depth = evaluate(port, batch)
    assert depth.shape == (48, 64) and metrics and all(np.isfinite(v) for v in metrics.values())
    agg = PortTester({}, port, loader).run(image_raw_shape=RAW, patch_split_num=SPLIT)
    assert agg and all(np.isfinite(v) for v in agg.values())


def test_branch_pretrained_is_read_by_neither(models, stage1):
    """``coarse_pretrain_cs_finetune.py`` names a checkpoint in its branch's
    ``pretrained``: the JAX package returns BaselinePretrain's variables as
    they are (it has no ``config``), and the port reads it neither."""
    paths, _ = stage1
    _, variables, _ = models("zoe_coarse")
    cfg = baseline_config("coarse", dict(ZOE, pretrained=paths["jax"]))
    assert j_apply_config_pretrained(MODELS.build(dict(cfg)), variables) is variables
    port = BaselinePretrain(dict(cfg, coarse_branch=dict(ZOE, pretrained=paths["coarse"])),
                            device="cpu", seed=4)
    before = {k: v.clone() for k, v in port.net.state_dict().items()}
    assert apply_config_pretrained(port) == {}
    assert all(torch.equal(v, before[k]) for k, v in port.net.state_dict().items())


# ---------------------------------------------------------------------- the CLIs
TINY_ZOE = "dict(n_bins=16, bin_embedding_dim=16, trunk=dict(embed_dim=64, depth=4, num_heads=4, " \
           "taps=[0, 1, 2, 3], features=32, out_channels=[24, 32, 48, 48]))"
DATA = "image_raw_shape=[96, 128], network_process_size=[48, 64], patch_raw_shape=[48, 64]"
TINY = f"""
_base_ = [{{base!r}}]
model = dict(image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
             coarse_branch={TINY_ZOE})
train_dataloader = dict(batch_size=2, dataset=dict(type="SyntheticDataset", mode="train", length=2,
                                                   {DATA}))
val_dataloader = dict(batch_size=1, dataset=dict(type="SyntheticDataset", mode="infer", length=1,
                                                 {DATA}))
test_in_dataloader = None
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1, val_interval=1,
                 train_log_img_interval=0)
"""
STAGE3 = f"""
_base_ = [{{base!r}}]
model = dict(config=dict(image_raw_shape=[96, 128], patch_process_shape=[48, 64],
                         patch_split_num=[2, 2], pretrain_coarse_model={{path!r}},
                         coarse_branch={TINY_ZOE}))
"""


def test_cli_stage1_then_hand_off(tmp_path):
    """``python -m patchrefinerv2_torch.train`` on ``coarse_pretrain_u4k.py``
    with the tiny network: a step of batch 2 with a finite ``coarse_loss``,
    the m1 validation's metrics logged, every tensor moved and saved under
    ``coarse_branch.``; ``.test`` evaluates the checkpoint (``normal``) and
    writes a pseudo label from it (``gen``); a ``Trainer`` resumes from it;
    a stage-3 config (``v2_eff_u4k.py``) takes it through
    ``pretrain_coarse_model``."""
    cfg_path = tmp_path / "stage1.py"
    cfg_path.write_text(TINY.format(
        base=str(ROOT / "configs/patchrefinerv2_zoedepth/coarse_pretrain_u4k.py")))
    init = build_model(Config.fromfile(str(cfg_path)).model, device="cpu", seed=5)
    wd = tmp_path / "wd"
    train_main([str(cfg_path), "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    lines = [json.loads(x) for x in (wd / "metrics.jsonl").read_text().splitlines()]
    steps = [x for x in lines if "coarse_loss" in x]
    val = [x for x in lines if "Val/abs_rel" in x]
    assert len(steps) == 1 and np.isfinite(steps[0]["total_loss"])
    assert len(val) == 1 and np.isfinite(val[0]["Val/abs_rel"])
    ckpt = str(wd / "checkpoint_01")
    post = load_checkpoint(ckpt)["state_dict"]
    assert sorted(post) == sorted(init.net.state_dict())
    params = dict(init.net.named_parameters())
    assert all(not torch.equal(v, post[k]) for k, v in params.items() if v.any())
    metrics = evaluate_main([str(cfg_path), "--ckp-path", ckpt, "--device", "cpu",
                            "--image-raw-shape", "96", "128", "--patch-split-num", "2", "2"])
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    labels = evaluate_main([str(cfg_path), "--ckp-path", ckpt, "--device", "cpu", "--test-type", "gen",
                           "--work-dir", str(tmp_path / "gen")])["pseudo_labels"]
    assert len(labels) == 1 and os.path.exists(labels[0])
    cfg = Config.fromfile(str(cfg_path))
    cfg["resume_from"] = ckpt
    loader = DataLoader(build_dataset(cfg.train_dataloader.dataset), batch_size=2)
    resumed = Trainer(cfg, build_model(cfg.model, device="cpu", seed=9), loader,
                      work_dir=str(tmp_path / "resumed"))
    assert (resumed.step, resumed.start_epoch) == (1, 2)
    assert all(torch.equal(v, post[k]) for k, v in resumed.model.net.state_dict().items())
    stage3 = tmp_path / "stage3.py"
    stage3.write_text(STAGE3.format(base=str(ROOT / "configs/patchrefinerv2_zoedepth/v2_eff_u4k.py"),
                                    path=ckpt))
    model = build_model(Config.fromfile(str(stage3)).model, device="cpu", seed=6)
    assert apply_config_pretrained(model)["pretrain_coarse_model"]["taken"] == len(post)
    got = model.net.state_dict()
    assert all(torch.equal(got[k], v) for k, v in post.items())
