"""PatchRefiner V1's training step against the JAX package, and its training
through the port's CLI, on the CPU.

tests/test_torch_v1.py's slice (the tiny BEiT ZoeDepth as the coarse and the
fine branch, FusionUnet) at 48x64 patches, with a batch of two images, two
crops with their boxes and 72x96 crop depths from a seed
(tests/test_torch_train_e2e.py's ``make_batch``). One JAX model for the
module, its variables from ``jax.eval_shape`` of its init with every leaf
drawn with numpy, loaded into the port through ``load_jax_params``. V1 has
no BatchNorm, so the step has no statistics to compare.

One step's loss dict (SILog, GradMatch, the total with ``sigweight`` 1),
its depth and every gradient leaf against ``jax.value_and_grad`` of the JAX
``PatchRefiner.loss``. Bars, as tests/test_torch_train_e2e.py sets them:

- float32: each loss max rel <= 1e-5; the depth max rel < 1e-4 and mean rel
  < 1e-5 (``assert_rel``); the whole gradient within 2e-2 of its norm.
- float64 (``slow``): each loss max rel <= 1e-5; each gradient leaf
  ||port - JAX|| / ||JAX|| <= 1e-4, a leaf's norm floored at 1e-6 of the
  whole gradient's.

The coarse branch is frozen: JAX's ``stop_gradient`` gives its leaves zero
gradients, the port runs it under no gradient so they get none, and the
CLI's optimizer leaves them as they were.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models.patchrefiner import PatchRefiner, build_model
from patchrefinerv2_torch.train import main as train_main
from patchrefinerv2_torch.training.optim import param_scales
from patchrefinerv2_torch.utils.checkpoint import load_checkpoint
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_mobile import random_variables
from tests.test_torch_slice import assert_rel
from tests.test_torch_train_e2e import HW, assert_losses, make_batch
from tests.test_torch_train_slice import grad_errors
from tests.test_torch_v1 import v1_config


@pytest.fixture(scope="module")
def jax_model():
    jm = MODELS.build(dict(type="PatchRefiner", config=v1_config()))
    return jm, random_variables(jm.init, 21), make_batch()


def jax_step(jm, variables, batch, dtype):
    """(loss dict, depth, gradients as the port's state-dict names) of
    JAX's V1 loss."""
    with jax.enable_x64(dtype == np.float64):
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables["params"])
        b = {k: jnp.asarray(np.asarray(x, dtype)) for k, x in batch.items()}

        def loss(p):
            ld, aux = jm.loss({"params": p}, b, mutable=["batch_stats"])
            return ld["total_loss"], (ld, aux["depth_pred"])

        (_, (ld, depth)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        return ({k: float(x) for k, x in ld.items()}, np.asarray(depth),
                jax_to_state_dict({"params": jax.device_get(grads)}))


def port_step(variables, batch, dtype, cfg=None):
    port = PatchRefiner(cfg or v1_config(), device="cpu")
    load_jax_params(port, variables)
    port.net.to(dtype)
    port.train()
    ld, aux = port.loss(batch, update_stats=True)
    ld["total_loss"].backward()
    return port, {k: float(v.detach()) for k, v in ld.items()}, aux


def assert_coarse_frozen(port, ref):
    """The port's coarse leaves get no gradient, JAX's zero ones; every
    other leaf gets one."""
    for k, p in port.net.named_parameters():
        if k.startswith("coarse_branch."):
            assert p.grad is None and not np.any(ref[k]), k
        else:
            assert p.grad is not None, k


def test_v1_step_float32(jax_model):
    jm, variables, batch = jax_model
    ref_losses, ref_depth, ref = jax_step(jm, variables, batch, np.float32)
    port, losses, aux = port_step(variables, batch, torch.float32)
    assert_losses(losses, ref_losses)
    assert losses["total_loss"] == losses["sig_fine_loss"]  # sigweight 1
    depth = aux["depth_pred"].detach().numpy()
    assert depth.shape == (2, *HW, 1)
    assert_rel(depth, ref_depth, "V1 training depth")
    assert_coarse_frozen(port, ref)
    errs = grad_errors(port, ref)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print("float32 gradient ||port - JAX|| / ||JAX||", d / n)  # shown with pytest -s
    assert d <= 2e-2 * n


@pytest.mark.slow  # composed parity, as the repo marks it: XLA's float64 step
def test_v1_step_matches_jax_float64(jax_model):
    jm, variables, batch = jax_model
    ref_losses, _, ref = jax_step(jm, variables, batch, np.float64)
    port, losses, _ = port_step(variables, batch, torch.float64)
    assert_losses(losses, ref_losses)
    assert_coarse_frozen(port, ref)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print("float64 worst gradient leaf", worst, errs[worst])
    for k, (d, n) in errs.items():
        assert d <= 1e-4 * max(n, 1e-6 * total), (k, d, n)


@pytest.fixture(scope="module")
def da2_model():
    """V1 with ``vitt`` DA2 coarse and fine branches (the form of
    ``patchrefiner_dav2/pr_u4k.py``) and FusionUnet, at 56x84 crops: a 4x6
    patch grid, so the fine DINOv2's position embedding goes through the
    bicubic K2 and its backward."""
    cfg = v1_config(da2_slice_config())
    jm = MODELS.build(dict(type="PatchRefiner", config=cfg))
    return cfg, jm, random_variables(jm.init, 21), make_batch(hw=(56, 84))


def test_da2_v1_loss_raises(da2_model):
    """The DA2 V1 step in float32 against JAX's (the loss through
    ``ZoeFineBranch(inner=DepthAnythingV2)``, ``patchrefiner.py:22-75``):
    each loss max rel <= 1e-5, the depth at the parity bar, the coarse
    branch without gradient, each gradient leaf within 1e-4 of its norm
    (floored at 1e-6 of the whole gradient's): without BatchNorm this step
    meets the per-leaf bar in float32, as BaselinePretrain's DA2 step does.
    The loss takes ``image_lr`` as the batch gives it, as JAX's does: sides
    that are not multiples of 14 still raise (the DINOv2 patch grid)."""
    cfg, jm, variables, batch = da2_model
    ref_losses, ref_depth, ref = jax_step(jm, variables, batch, np.float32)
    port, losses, aux = port_step(variables, batch, torch.float32, cfg)
    assert_losses(losses, ref_losses)
    assert_rel(aux["depth_pred"].detach().numpy(), ref_depth, "DA2 V1 training depth")
    assert_coarse_frozen(port, ref)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print("DA2 V1 float32 worst gradient leaf", worst, errs[worst])  # shown with pytest -s
    for k, (d, n) in errs.items():
        assert d <= 1e-4 * max(n, 1e-6 * total), (k, d, n)
    assert errs["refiner_fine_branch.pretrained.pos_embed"][1] > 1e-6 * total
    with pytest.raises(ValueError, match="multiples of 14"):
        port.loss(dict(batch, image_lr=batch["image_lr"][:, :50]), update_stats=True)


TINY_ZOE = "dict(n_bins=16, bin_embedding_dim=16, trunk=dict(embed_dim=64, depth=4, num_heads=4, " \
           "taps=[0, 1, 2, 3], features=32, out_channels=[24, 32, 48, 48]))"
TINY = f"""
_base_ = [{{base!r}}]
model = dict(config=dict(
    image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
    coarse_branch={TINY_ZOE},
    refiner=dict(fine_branch={TINY_ZOE}, fusion_model=dict(
        input_chl=[64] * 6, temp_chl=[16, 32, 32, 32, 32, 32], dec_chl=[32, 32, 32, 32, 16]))))
train_dataloader = dict(batch_size=2, dataset=dict(
    type="SyntheticDataset", mode="train", length=4, image_raw_shape=[96, 128],
    network_process_size=[48, 64], patch_raw_shape=[48, 64]))
val_dataloader = None
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1,
                 train_log_img_interval=0)
"""


def test_cli_trains_v1(tmp_path):
    """``python -m patchrefinerv2_torch.train`` on ``pr_u4k.py`` with the
    tiny trunk in both branches, two steps of batch 2: the checkpoint holds
    the coarse branch as it was built (frozen) and every fine and fusion
    tensor moved; two finite losses logged; the fine network's
    ``refiner_fine_branch.core`` takes the config's lr_mult of 0.1."""
    cfg_path = tmp_path / "v1.py"
    cfg_path.write_text(TINY.format(base=os.path.abspath("configs/patchrefiner_zoedepth/pr_u4k.py")))
    cfg = Config.fromfile(str(cfg_path))
    init = build_model(cfg.model, device="cpu", seed=5)
    assert isinstance(init, PatchRefiner)
    names = [n for n, _ in init.net.named_parameters()]
    scales = param_scales(names, cfg.optim_wrapper.paramwise_cfg.custom_keys)
    core = [n for n in names if n.startswith("refiner_fine_branch.core.")]
    assert core and all(scales[n] == 0.1 for n in core)
    assert all(scales[n] == 1.0 for n in names if n.startswith("refiner_fusion_model."))
    wd = tmp_path / "wd"
    train_main([str(cfg_path), "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    lines = (wd / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all(np.isfinite(json.loads(x)["total_loss"]) for x in lines)
    post = load_checkpoint(str(wd / "checkpoint_01"))["state_dict"]
    for k, v in init.net.state_dict().items():
        same = torch.equal(v, post[k])
        assert same if k.startswith("coarse_branch.") else not same, k
