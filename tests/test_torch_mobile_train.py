"""PatchRefinerV2-Mobile's two training stages in the port against the JAX
package, on the CPU, and through the port's ``train`` CLI.

- The pretraining stage (``patchrefinerv2_zoedepth_ablation/
  pretrain_mobile_m0s1.py``: no coarse branch, the MobileNetV4-small refiner
  with a 3-channel stem and its SimpleDPTHead decoder over [32, 32, 64, 96,
  960], the fusion head at the decoder's widths, hacked coarse features).
- Stage 3 (``patchrefinerv2_zoedepth/v2_mobile_u4k.py``: ``e2e_training``,
  the coarse branch trained through roi_align, the refiner with its coarse
  condition, ``remat`` on both sides).

Both at tests/test_torch_mobile.py's slice (a 4-block BEiT) and 48x64
patches, one JAX model per stage: its variables from ``jax.eval_shape`` of
its init, drawn with numpy from a seed, loaded into the port. The JAX
pretraining stage runs with remat off (it cannot build it with remat on:
tests/test_torch_train_slice.py says why), the port with remat on. One
step's losses, every gradient leaf and the BatchNorm statistics after the
step against ``jax.value_and_grad`` of ``PatchRefinerPlus.loss`` with
``mutable=["batch_stats"]``, to the bars of
tests/test_torch_train_{slice,e2e}.py:

- float32: each loss max rel <= 1e-5; the whole gradient within 2e-2 of
  its norm (the step is ill-conditioned in float32 at these sizes, as
  tests/test_torch_train_slice.py's docstring shows); each BatchNorm
  statistic within 1e-4 of its leaf's largest value; stage 3's coarse
  prediction within 1e-5 of its magnitude.
- float64 (marked ``slow``, as the repo marks composed parity: JAX's
  float64 steps take minutes beside the other test workers): each loss
  max rel <= 1e-5, each gradient leaf ||port - JAX|| / ||JAX|| <= 1e-4
  (a leaf's norm floored at 1e-6 of the whole gradient's), each
  statistic within 1e-5 of its leaf's largest value.

Then the CLI trains the pretraining stage and stage 3 from its checkpoint
(``pretrained``) at a tiny size, MobileNetV4's parameters updated at the
config's ``lr_mult`` of 0.1.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.parallel.bn import bn_groups, set_bn_groups

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models.backbones.encoders import BatchNorm
from patchrefinerv2_torch.models.backbones.mobilenetv4 import MobileNetV4Features
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.train import main as train_main
from patchrefinerv2_torch.training.optim import param_scales
from patchrefinerv2_torch.utils.checkpoint import load_checkpoint
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import build_both, mobile_config
from tests.test_torch_train_e2e import make_batch
from tests.test_torch_train_slice import grad_errors, hacked_draws, stats_of

B = 2
HW = (48, 64)
KEY = jax.random.PRNGKey(3)


def stage_config(stage: str, remat: bool = True) -> dict:
    """The mobile slice at 48x64 patches as the pretraining stage or as stage 3."""
    cfg = mobile_config()
    h, w = HW
    cfg.update(remat=remat, patch_process_shape=[h, w], image_raw_shape=[2 * h, 2 * w])
    if stage == "pretrain":
        cfg.update(pretrain_stage=True, hack_strategy="mean_0_std_1")
        cfg["refiner"]["fine_branch"].update(coarse_condition=False, with_decoder=True)
    else:
        cfg.update(e2e_training=True)
    return cfg


def stage_batch(stage: str) -> dict:
    if stage == "pretrain":
        rng = np.random.RandomState(5)
        h, w = HW
        return dict(image_lr=rng.rand(B, h, w, 3), depth_gt=1.0 + 20.0 * rng.rand(B, 2 * h, 2 * w, 1))
    return make_batch(HW)


@pytest.fixture(scope="module", autouse=True)
def one_bn_group():
    groups = bn_groups()
    set_bn_groups(1)  # one device: per-batch BatchNorm moments
    yield
    set_bn_groups(groups)


@pytest.fixture(scope="module", params=["pretrain", "stage3"])
def case(request):
    """(stage, JAX model, variables, batch); the JAX pretraining stage with
    remat off."""
    stage = request.param
    jm, variables, _ = build_both(stage_config(stage, remat=stage != "pretrain"))
    return stage, jm, variables, stage_batch(stage)


def jax_step(stage, jm, variables, batch, dtype):
    """(losses, coarse prediction or None, gradients and statistics after the
    step as the port's state-dict names) of JAX's loss in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        b = {k: jnp.asarray(np.asarray(x, dtype)) for k, x in batch.items()}

        def loss(p):
            ld, aux = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, b, rng=KEY,
                              mutable=["batch_stats"])
            return ld["total_loss"], (ld, aux.get("coarse_prediction"), aux["variables"]["batch_stats"])

        (_, (ld, coarse, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        return ({k: float(x) for k, x in ld.items()}, None if coarse is None else np.asarray(coarse),
                jax_to_state_dict({"params": jax.device_get(grads), "batch_stats": jax.device_get(stats)}))


def port_step(stage, variables, batch, dtype):
    """The port's step in ``dtype`` with remat on; the pretraining stage on
    the JAX step's hacked draws."""
    port = PatchRefinerPlus(stage_config(stage), device="cpu")
    load_jax_params(port, variables)
    port.net.to(dtype).train()
    cf = None
    if stage == "pretrain":
        with jax.enable_x64(dtype == torch.float64):
            draws = hacked_draws(port, batch, np.float64 if dtype == torch.float64 else np.float32)
        cf = [torch.from_numpy(np.array(d)).permute(0, 3, 1, 2) for d in draws]
    ld, aux = port.loss(batch, update_stats=True, coarse_features=cf)
    ld["total_loss"].backward()
    return port, {k: float(v.detach()) for k, v in ld.items()}, aux


def assert_losses(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, got[k], ref[k])


def test_step_float32(case):
    stage, jm, variables, batch = case
    ref_losses, ref_coarse, ref = jax_step(stage, jm, variables, batch, np.float32)
    port, losses, aux = port_step(stage, variables, batch, torch.float32)
    assert_losses(losses, ref_losses)
    if stage == "stage3":
        coarse = aux["coarse_prediction"].detach().numpy()
        assert coarse.shape == ref_coarse.shape == (B, *HW, 1)
        assert np.abs(coarse - ref_coarse).max() <= 1e-5 * np.abs(ref_coarse).max()
    errs = grad_errors(port, ref)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print(f"{stage} float32 gradient ||port - JAX|| / ||JAX||", d / n)  # shown with pytest -s
    assert d <= 2e-2 * n
    enc = [k for k in errs if k.startswith("refiner_fine_branch.refiner_encoder.")]
    assert any(".pw_exp." in k for k in enc) and all(errs[k][1] > 0 for k in enc)
    for k, got in stats_of(port).items():
        assert np.abs(got - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k


@pytest.mark.slow  # composed parity, as the repo marks it: JAX's float64 steps take minutes
def test_step_matches_jax_float64(case):
    stage, jm, variables, batch = case
    ref_losses, _, ref = jax_step(stage, jm, variables, batch, np.float64)
    port, losses, _ = port_step(stage, variables, batch, torch.float64)
    assert_losses(losses, ref_losses)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print(f"{stage} float64 worst gradient leaf", worst, errs[worst])
    for k, (d, n) in errs.items():
        assert d <= 1e-4 * max(n, 1e-6 * total), (k, d, n)
    for k, got in stats_of(port).items():
        assert np.abs(got - ref[k]).max() <= 1e-5 * np.abs(ref[k]).max(), k


TINY = """
_base_ = [{base!r}]
model = dict(config=dict(
    image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
    pretrained={pretrained!r},
    coarse_branch=dict(n_bins=16, bin_embedding_dim=16, trunk=dict(
        embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3], features=32,
        out_channels=[24, 32, 48, 48]))))
train_dataloader = dict(batch_size=2, dataset=dict(
    type="SyntheticDataset", mode="{mode}", length=2, image_raw_shape=[96, 128],
    network_process_size=[48, 64], patch_raw_shape=[48, 64]))
val_dataloader = None
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1,
                 train_log_img_interval=0)
"""


def test_cli_trains_both_stages(tmp_path):
    """``python -m patchrefinerv2_torch.train`` on ``pretrain_mobile_m0s1``
    (one step of batch 2), then on ``v2_mobile_u4k`` from its checkpoint:
    each writes a checkpoint and finite losses; the refiner's MobileNetV4
    parameters take the ``refiner_fine_branch.refiner_encoder`` lr_mult of
    0.1, and its BatchNorm statistics move in the stage-3 step."""
    here = os.path.abspath("configs")
    pre_cfg = tmp_path / "pre.py"
    pre_cfg.write_text(TINY.format(
        base=os.path.join(here, "patchrefinerv2_zoedepth_ablation/pretrain_mobile_m0s1.py"),
        pretrained=None, mode="train"))
    train_main([str(pre_cfg), "--work-dir", str(tmp_path / "pre"), "--device", "cpu", "--seed", "5"])
    ckpt = tmp_path / "pre" / "checkpoint_01"
    assert ckpt.exists()
    s3_cfg = tmp_path / "s3.py"
    s3_cfg.write_text(TINY.format(base=os.path.join(here, "patchrefinerv2_zoedepth/v2_mobile_u4k.py"),
                                  pretrained=str(ckpt), mode="train"))
    cfg = Config.fromfile(str(s3_cfg))
    model = PatchRefinerPlus(cfg.model.config, device="cpu")
    enc = model.net.refiner_fine_branch.refiner_encoder
    assert isinstance(enc, MobileNetV4Features)
    bns = [m for m in enc.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 45 and all(m.eps == 1e-5 for m in bns)
    names = [n for n, _ in model.net.named_parameters()]
    scales = param_scales(names, cfg.optim_wrapper.paramwise_cfg.custom_keys)
    mnv4 = [n for n in names if n.startswith("refiner_fine_branch.refiner_encoder.")]
    assert mnv4 and all(scales[n] == 0.1 for n in mnv4)
    wd = tmp_path / "s3"
    train_main([str(s3_cfg), "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    assert (wd / "checkpoint_01").exists()
    lines = (wd / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["total_loss"])
    pre = load_checkpoint(str(ckpt))["state_dict"]
    post = load_checkpoint(str(wd / "checkpoint_01"))["state_dict"]
    key = "refiner_fine_branch.refiner_encoder.blocks.2.0.pw_exp.bn.running_var"
    assert pre[key].shape == post[key].shape and not torch.equal(pre[key], post[key])
