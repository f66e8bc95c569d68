"""PatchRefinerSemi with a ``PatchRefinerPlus`` student against the JAX
package on the CPU, and what the port builds, loads and trains of it.

The tiny flagship topology of tests/test_torch_slice.py (a 4-block BEiT,
the ZoeDepth head, the EfficientNet-B5 refiner, BiDirectionalFusion) as the
student and, online, as the teacher, at 48x64 patches with the batch of
tests/test_torch_train_e2e.py. One JAX ``PatchRefinerSemi`` a case, its
variables (``{"params": {"student", "teacher"}, "batch_stats": ...}``) from
``jax.eval_shape`` of its init with every leaf drawn with numpy, loaded into
the port through ``load_jax_params(part="PatchRefinerSemi")``.

One training step against ``jax.value_and_grad`` of JAX's
``PatchRefinerSemi.loss`` with ``mutable=["batch_stats"]``, at the bars of
tests/test_torch_train_e2e.py: each loss (the student's three and the edge
loss) max rel <= 1e-5, the pseudo label and the depth within ``assert_rel``,
the whole gradient within 2e-2 of its norm, each BatchNorm statistic within
1e-4 of its leaf's largest value (float32); in float64 (``slow``) the
bars its docstring gives. Here online with the SSI-DA edge
loss (``semi_online_cs.py``); the offline and ranking steps are in
tests/test_torch_semi_steps.py, the V1 student's in
tests/test_torch_semi_v1.py. The teacher's leaves and the student's coarse
branch get zero gradients in JAX (``stop_gradient``) and none in the port.

Then the JAX optimizer's behaviour under Semi, pinned on both sides: the
frozen prefix and the ``lr_mult`` keys match only at the tree's root, so
the teacher's and the student's coarse leaves decay by ``lr * wd`` and the
student's refiner encoder steps at the full learning rate; the weights'
round trip; the 20 Semi configs on the meta device; the CLI on a tiny
online ranking config; what raises.
"""

import glob
import json
import os
import shutil
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.training.optim import build_optimizer as j_build_optimizer

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models import patchrefinerplus as prp
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.models.patchrefiner_semi import PatchRefinerSemi
from patchrefinerv2_torch.train import main as train_main
from patchrefinerv2_torch.training.optim import build_optimizer
from patchrefinerv2_torch.utils.checkpoint import apply_config_pretrained, load_checkpoint
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import random_variables
from tests.test_torch_slice import assert_rel, slice_config
from tests.test_torch_train_e2e import HW, make_batch, one_bn_group  # noqa: F401 (autouse)
from tests.test_torch_train_slice import grad_errors, stats_of


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: a checkpoint written
    here takes up to 1.5 GB, and pytest keeps the temp dirs of three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


KEY = jax.random.PRNGKey(31)
ROOT = pathlib.Path(__file__).resolve().parent.parent
SSI_DA = dict(type="ScaleAndShiftInvariantDALoss", grad_matching=True)
SSI_GM = dict(type="ScaleAndShiftInvariantLoss", only_missing_area=False, grad_matching=True)
RANKING = dict(type="EdgeguidedRankingLoss", min_depth=1e-3, max_depth=80, alpha=1,
               reweight_target=False, only_missing_area=False, point_pairs=200)


def semi_config(student: dict, online: bool, edgeloss: dict) -> dict:
    return dict(type="PatchRefinerSemi", model_cfg_student=student,
                model_cfg_teacher=student if online else None, teacher_pretrain=None,
                edgeloss=edgeloss, edge_loss_weight=0.5)


def plus_student() -> dict:
    return dict(type="PatchRefinerPlus", config=slice_config())


def build_semi(cfg: dict, seed: int = 21):
    """The JAX PatchRefinerSemi, its random variables and the port with them."""
    jm = MODELS.build(dict(cfg))
    variables = random_variables(jm.init, seed)
    port = PatchRefinerSemi(cfg, device="cpu")
    load_jax_params(port, variables, part="PatchRefinerSemi")
    return jm, variables, port


def semi_batch(online: bool) -> dict:
    batch = make_batch()
    if not online:
        batch["pseudo_label"] = 1.0 + 15.0 * np.random.RandomState(8).rand(2, *HW, 1)
    return batch


def jax_semi_step(jm, variables, batch, dtype, key=KEY):
    """(loss dict, depth, pseudo label, gradients and batch statistics as
    the port's state-dict names) of JAX's Semi loss."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        b = {k: jnp.asarray(np.asarray(x, dtype)) for k, x in batch.items()}

        def loss(p):
            ld, aux = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, b, rng=key,
                              mutable=["batch_stats"])
            stats = (aux["variables"] or {}).get("batch_stats", {})  # V1 has none
            return ld["total_loss"], (ld, aux["depth_pred"], aux["pseudo_label"], stats)

        (_, (ld, depth, pseudo, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v["params"])
        tree = {"params": jax.device_get(grads), "batch_stats": jax.device_get(stats)}
        return ({k: float(x) for k, x in ld.items()}, np.asarray(depth), np.asarray(pseudo),
                jax_to_state_dict(tree, "PatchRefinerSemi"))


def port_semi_step(port, batch, dtype=torch.float32, edge_samples=None):
    port.net.to(dtype)
    port.train()
    ld, aux = port.loss(batch, update_stats=True, edge_samples=edge_samples)
    ld["total_loss"].backward()
    return {k: float(v.detach()) for k, v in ld.items()}, aux


def assert_semi_losses(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref) == ["edge_loss", "gm_loss", "sig_fine_loss", "total_loss"]
    assert ref["edge_loss"] > 0
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, got[k], ref[k])


def assert_teacher_and_coarse_without_gradient(port, ref) -> None:
    for k, p in port.net.named_parameters():
        if k.startswith(("teacher.", "student.coarse_branch.")):
            assert p.grad is None and not np.any(ref[k]), k
        else:
            assert p.grad is not None, k


def check_float32_step(jm, variables, port, batch, samples_of=None, key=KEY):
    """The float32 step against JAX's; ``samples_of(pseudo label)`` gives
    the ranking loss's samples from JAX's pseudo label."""
    ref_losses, ref_depth, ref_pseudo, ref = jax_semi_step(jm, variables, batch, np.float32, key)
    edge_samples = None if samples_of is None else samples_of(ref_pseudo)
    losses, aux = port_semi_step(port, batch, edge_samples=edge_samples)
    assert_semi_losses(losses, ref_losses)
    assert_rel(aux["depth_pred"].detach().numpy(), ref_depth, "Semi student depth")
    assert_rel(aux["pseudo_label"].numpy(), ref_pseudo, "Semi pseudo label")
    assert_teacher_and_coarse_without_gradient(port, ref)
    errs = grad_errors(port, ref)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print("float32 gradient ||port - JAX|| / ||JAX||", d / n)  # shown with pytest -s
    assert d <= 2e-2 * n
    stats = stats_of(port)  # V1 has no BatchNorm
    assert all(k.startswith(("student.", "teacher.")) for k in stats)
    for k, got in stats.items():
        assert np.abs(got - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k
    return losses


@pytest.fixture(scope="module")
def online():
    return build_semi(semi_config(plus_student(), True, SSI_DA))


def test_semi_online_step_float32(online):
    jm, variables, port = online
    check_float32_step(jm, variables, port, semi_batch(True))
    assert stats_of(port)
    # the teacher's statistics are its running ones: only the student's move
    after = stats_of(port)
    loaded = jax_to_state_dict(variables, "PatchRefinerSemi")
    assert all(np.array_equal(v, loaded[k]) for k, v in after.items() if k.startswith("teacher."))
    assert not all(np.array_equal(v, loaded[k]) for k, v in after.items() if k.startswith("student."))


@pytest.mark.slow  # composed parity, as the repo marks it: XLA's float64 step
def test_semi_online_step_matches_jax_float64(online):
    """Each loss within 1e-5; the whole gradient within 2e-3 of its norm and
    each leaf within 5e-3 of its own (floored at 1e-6 of the whole
    gradient's). Looser than stage 3's 1e-4 a leaf: both sides take the
    losses of float32 predictions (the JAX package casts the depth to
    float32 first, ``patchrefinerplus.py:543-544``), and the edge loss
    standardises the student's depth and the teacher's pseudo label, whose
    float32 sums cancel: measured, the whole gradient 4.6e-4 of its norm
    apart and the worst leaf (a squeeze-excite conv of the refiner) 9.8e-4,
    with the edge loss 2.7e-7 apart."""
    jm, variables, _ = online
    port = PatchRefinerSemi(semi_config(plus_student(), True, SSI_DA), device="cpu")
    load_jax_params(port, variables, part="PatchRefinerSemi")
    batch = semi_batch(True)
    ref_losses, _, _, ref = jax_semi_step(jm, variables, batch, np.float64)
    losses, _ = port_semi_step(port, batch, torch.float64)
    assert_semi_losses(losses, ref_losses)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    assert np.sqrt(sum(d ** 2 for d, _ in errs.values())) <= 2e-3 * total
    for k, (d, n) in errs.items():
        assert d <= 5e-3 * max(n, 1e-6 * total), (k, d, n)


def test_optimizer_under_semi_matches_jax(online):
    """One step of ``semi_online_cs.py``'s optimizer on both sides, with a
    gradient on the student's refiner encoder only: every update equals
    JAX's; the teacher's and the student's coarse leaves decay by ``lr * wd``
    (6e-7 of a leaf at the first step); the encoder, whose config key is
    ``lr_mult`` 0.1 at the root, steps at the full learning rate."""
    _, variables, port = online
    cfg = Config.fromfile(str(ROOT / "configs/patchrefinerv2_zoedepth_cs/semi_online_cs.py"))
    enc = "student.refiner_fine_branch.refiner_encoder."
    rng = np.random.RandomState(4)
    grads_j = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    enc_tree = grads_j["student"]["fine"]["refiner_encoder"]
    grads_j["student"]["fine"]["refiner_encoder"] = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), enc_tree)
    tx, sched = j_build_optimizer(cfg.optim_wrapper, cfg.param_scheduler, 100, variables["params"],
                                  frozen_prefixes=(("coarse",),))
    updates = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads_j, variables["params"])
    ref = jax_to_state_dict({"params": jax.device_get(updates), "batch_stats": variables["batch_stats"]},
                            "PatchRefinerSemi")
    load_jax_params(port, variables, part="PatchRefinerSemi")
    port.net.float()
    opt, _ = build_optimizer(cfg.optim_wrapper, cfg.param_scheduler, 100, port.net.named_parameters(),
                             frozen_prefixes=("coarse_branch",))
    assert set(opt.mu) == {k for k, _ in port.net.named_parameters()}  # the teacher's moments too
    g = jax_to_state_dict({"params": grads_j, "batch_stats": variables["batch_stats"]}, "PatchRefinerSemi")
    before = {}
    for k, p in port.net.named_parameters():
        p.grad = torch.from_numpy(g[k]) if k.startswith(enc) else None
        before[k] = p.detach().clone()
    opt.step()
    lr_wd = float(sched(0)) * 0.01
    assert lr_wd == pytest.approx(6e-7, rel=1e-6)
    for k, p in port.net.named_parameters():
        # the update as the step applied it: p + u rounds to p's float32 grid
        old = before[k].numpy()
        delta, ulp = (p.detach() - before[k]).numpy(), np.spacing(np.abs(old))
        assert (np.abs(delta - ref[k]) <= 1e-5 * np.abs(ref[k]).max() + ulp).all(), k
        if k.startswith(("teacher.", "student.coarse_branch.")):
            assert (np.abs(delta + lr_wd * old) <= 1e-6 * np.abs(lr_wd * old) + ulp).all(), k
        elif k.startswith(enc):  # Adam's first step: about lr per element, not 0.1 lr
            assert np.abs(delta).max() > 0.9 * float(sched(0)), k


def test_every_jax_leaf_is_loaded(online):
    """The Semi part reads every JAX leaf (the loader's state dict has as
    many tensors as the tree has leaves) and sets every port tensor."""
    _, variables, port = online
    leaves = len(jax.tree_util.tree_leaves(variables))
    sd = jax_to_state_dict(variables, "PatchRefinerSemi")
    assert len(sd) == leaves
    with torch.no_grad():
        for t in port.net.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    load_jax_params(port, variables, part="PatchRefinerSemi")
    assert all(bool(torch.isfinite(t).all()) for t in port.net.state_dict().values())
    own = port.net.state_dict()
    assert all(np.array_equal(v, own[k].numpy()) for k, v in sd.items())


def test_teacher_pretrain_and_sub_models_keys(tmp_path, online):
    """``apply_config_pretrained`` recurses into the student and the teacher
    and merges ``teacher_pretrain`` into the teacher; a missing path keeps
    the random init."""
    _, _, port = online
    port.net.float()
    ckpt = {k: torch.full_like(v, 0.5) for k, v in port.teacher.net.state_dict().items()}
    path = tmp_path / "teacher.pth"
    torch.save({"state_dict": ckpt}, path)
    student = {k: v.clone() for k, v in port.student.net.state_dict().items()}
    port.teacher_pretrain = str(path)
    port.student.config.update(pretrained=str(tmp_path / "missing"))
    try:
        report = apply_config_pretrained(port)
    finally:
        port.teacher_pretrain = None
        port.student.config.update(pretrained=None)
    assert report["teacher_pretrain"]["taken"] == len(ckpt) and "student.pretrained" not in report
    assert all(bool((v == 0.5).all()) for v in port.teacher.net.state_dict().values()
               if v.is_floating_point())
    assert all(torch.equal(v, student[k]) for k, v in port.student.net.state_dict().items())
    port.teacher_pretrain = str(tmp_path / "missing")
    try:
        assert apply_config_pretrained(port) == {}
    finally:
        port.teacher_pretrain = None


SEMI_CONFIGS = sorted(
    f for f in glob.glob(str(ROOT / "configs" / "**" / "*.py"), recursive=True)
    if Config.fromfile(f).get("model", {}).get("type") == "PatchRefinerSemi")


def test_semi_configs_found():
    """20 configs: 9 online (5 with a V1 student), 11 offline (7 V1, and the
    DA2 ``semi_kitti.py``)."""
    models = [Config.fromfile(f).model for f in SEMI_CONFIGS]
    online = [m for m in models if m.get("model_cfg_teacher")]
    v1 = [m for m in models if m.model_cfg_student.type == "PatchRefiner"]
    assert (len(models), len(online), len(v1)) == (20, 9, 12)


@pytest.mark.parametrize("path", SEMI_CONFIGS, ids=lambda p: pathlib.Path(p).parent.name + "/" +
                         os.path.basename(p))
def test_semi_configs_build(path, monkeypatch):
    """Each builds on the meta device (no random init there): the student
    and, online, the teacher of the config's types under ``student.`` and
    ``teacher.``, its edge loss; the DA2 student's loss raises."""
    monkeypatch.setattr(prp, "init_random_", lambda net, generator: net)
    m = Config.fromfile(path).model
    with torch.device("meta"):
        semi = build_model(m, device="meta")
    assert isinstance(semi, PatchRefinerSemi)
    assert type(semi.student).__name__ == m.model_cfg_student.type
    assert (semi.teacher is None) == (not m.get("model_cfg_teacher"))
    names = [n for n, _ in semi.net.named_parameters()]
    assert names and all(n.startswith(("student.", "teacher.")) for n in names)
    assert type(semi.edgeloss).__name__ == m.edgeloss.type
    if m.get("mix_loss"):
        assert semi.edgeloss_ranking.point_pairs == 10000
    if os.path.basename(path) == "semi_kitti.py":
        batch = {k: torch.as_tensor(v) for k, v in make_batch().items()}
        batch["pseudo_label"] = torch.ones((2, *HW, 1))
        with pytest.raises(NotImplementedError, match="ZoeDepth coarse branch"):
            semi.train().loss(batch, update_stats=True)


def test_unported_semi_forms_raise():
    base = semi_config(plus_student(), True, SSI_DA)
    with pytest.raises(NotImplementedError, match="distill"):
        PatchRefinerSemi(dict(base, distill=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ScaleAndShiftInvariantUncertLoss"):
        PatchRefinerSemi(dict(base, edgeloss=dict(type="ScaleAndShiftInvariantUncertLoss")),
                         device="cpu")


def test_offline_without_pseudo_label_raises(online):
    """Offline, the pseudo label comes from the batch, as in JAX: a batch
    without one raises."""
    _, _, port = online
    teacher, port.teacher = port.teacher, None
    try:
        with pytest.raises(KeyError, match="pseudo_label"):
            port.train().loss(make_batch(), update_stats=True)
    finally:
        port.teacher = teacher


TINY_ZOE = "dict(n_bins=16, bin_embedding_dim=16, trunk=dict(embed_dim=64, depth=4, num_heads=4, " \
           "taps=[0, 1, 2, 3], features=32, out_channels=[24, 32, 48, 48]))"
TINY_STUDENT = f"""dict(config=dict(
    image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
    coarse_branch={TINY_ZOE}, refiner=dict(fusion_model=dict(
        coarse_chl=[32, 16, 16, 16, 16, 32], fine_chl_after_coarse2fine=[32, 64, 64, 64, 64, 64]))))"""
TINY = f"""
_base_ = [{{base!r}}]
model = dict(model_cfg_student={TINY_STUDENT}, model_cfg_teacher={TINY_STUDENT},
             edgeloss=dict(point_pairs=200))
train_dataloader = dict(batch_size=2, dataset=dict(
    _delete_=True, type="SyntheticDataset", mode="train", length=4, network_process_size=[48, 64],
    patch_raw_shape=[48, 64]{{raw}}))
val_dataloader = None
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1, train_log_img_interval=0)
"""


def test_cli_trains_semi_online(tmp_path):
    """``python -m patchrefinerv2_torch.train`` on
    ``plus_eff_cs_semi_online_ranking_ft.py`` with the tiny topology in the
    student and the teacher: the synthetic frames must be given the model's
    raw geometry; two steps of batch 2 log finite losses and the ranking
    edge loss; the checkpoint holds the teacher and the student's coarse
    branch decayed (every tensor moved, none by more than 2 lr wd of its
    size) and the student's other parameters moved."""
    base = str(ROOT / "configs/patchrefinerv2_zoedepth_cs/plus_eff_cs_semi_online_ranking_ft.py")
    bad = tmp_path / "bad.py"
    bad.write_text(TINY.format(base=base, raw=""))
    with pytest.raises(ValueError, match=r"train_dataloader.dataset.image_raw_shape=\[96,128\]"):
        train_main([str(bad), "--work-dir", str(tmp_path / "bad"), "--device", "cpu"])
    cfg_path = tmp_path / "semi.py"
    cfg_path.write_text(TINY.format(base=base, raw=", image_raw_shape=[96, 128]"))
    init = build_model(Config.fromfile(str(cfg_path)).model, device="cpu", seed=5)
    wd = tmp_path / "wd"
    train_main([str(cfg_path), "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    lines = [json.loads(x) for x in (wd / "metrics.jsonl").read_text().splitlines()]
    # the random teacher's pseudo label is flat, without a canny edge: the
    # ranking loss is logged, and 0 (tests/test_torch_semi_steps.py has edges)
    assert len(lines) == 2 and all(np.isfinite(x["total_loss"]) and x["edge_loss"] == 0 for x in lines)
    post = load_checkpoint(str(wd / "checkpoint_01"))["state_dict"]
    params = dict(init.net.named_parameters())
    for k, v in init.net.state_dict().items():
        if k not in params:
            continue
        moved = (post[k] - v).abs()
        if k.startswith(("teacher.", "student.coarse_branch.")):
            assert bool((moved <= 2 * 1.2e-4 * 0.01 * v.abs() + 1e-12).all()), k
        assert not torch.equal(v, post[k]) or not v.any(), k
