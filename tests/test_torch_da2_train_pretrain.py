"""Refiner pretraining for the Depth-Anything-V2 recipe
(``patchrefinerv2_dav2/pretrain_eff_m0s1.py`` and ``pretrain_mobile_m0s1.py``)
on the port against the JAX package, on the CPU.

Each config's own model at 56x84 images (its 112x168 depth), remat off (the
JAX package cannot init these configs with ``remat=True``; remat changes no
value, tests/test_torch_train_slice.py): the EfficientNet-B5 or the
MobileNetV4-small refiner with its decoder, and BiDirectionalFusion at the
DA2 widths, on hacked coarse features whose highest-resolution level is 128
wide where a ZoeDepth recipe's is 32 (``coarse_is_da2``,
``patchrefinerplus.py:316-338``). ``mean_0_std_1`` draws them as JAX's
``pretrain_forward`` does (split, then a normal a level, from the loss's
key), and the port takes those draws; ``constant`` is ones on both sides.
One JAX model a case, its variables from ``jax.eval_shape`` of its init
with every leaf drawn with numpy, loaded into the port through
``load_jax_params``; inputs from a numpy seed.

One step's loss, depth, every gradient leaf and the BatchNorm statistics
after it, against ``jax.value_and_grad`` of JAX's loss, float32: the loss
max rel <= 1e-5; the depth within 1e-4 of its magnitude (measured 4.7e-5;
it is the ReLU of the head's output, 0 or a few hundredths at random
weights, so the parity bar's relative error, floored at 1e-3, would
measure rounding near 0); the whole
gradient within 2e-2 of its norm and each statistic within 1e-4 of its
leaf's largest value, tests/test_torch_train_slice.py's float32 bars (the
step's train-mode BatchNorm over the deepest maps, 2x3 pixels, is
ill-conditioned per leaf in float32).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import random_variables
from tests.test_torch_train_e2e import one_bn_group  # noqa: F401 (autouse)
from tests.test_torch_train_slice import KEY, grad_errors, hacked_draws, stats_of

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {"eff": "configs/patchrefinerv2_dav2/pretrain_eff_m0s1.py",
           "mobile": "configs/patchrefinerv2_dav2/pretrain_mobile_m0s1.py"}
HW = (56, 84)


def pretrain_config(name: str, strategy: str) -> dict:
    cfg = Config.fromfile(str(ROOT / CONFIGS[name])).model.config.to_dict()
    cfg.update(hack_strategy=strategy, remat=False, patch_process_shape=list(HW),
               image_raw_shape=[2 * HW[0], 2 * HW[1]])
    return cfg


def make_batch() -> dict:
    rng = np.random.RandomState(5)
    return dict(image_lr=rng.rand(2, *HW, 3), depth_gt=1.0 + 20.0 * rng.rand(2, 2 * HW[0], 2 * HW[1], 1))


def jax_step(jm, variables, batch):
    """(loss, depth, gradients and batch stats after the step as the port's
    state-dict names) of JAX's float32 pretraining loss with ``KEY``."""
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)
    b = {k: jnp.asarray(np.asarray(x, np.float32)) for k, x in batch.items()}

    def loss(p):
        ld, aux = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, b, rng=KEY,
                          mutable=["batch_stats"])
        return ld["total_loss"], (aux["depth_pred"], aux["variables"]["batch_stats"])

    (value, (depth, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    return float(value), np.asarray(depth), jax_to_state_dict(
        {"params": jax.device_get(grads), "batch_stats": jax.device_get(stats)})


@pytest.mark.parametrize("name,strategy", [("eff", "mean_0_std_1"), ("eff", "constant"),
                                           ("mobile", "mean_0_std_1")])
def test_da2_pretrain_step_float32(name, strategy):
    cfg = pretrain_config(name, strategy)
    assert cfg["pretrain_stage"] and cfg["coarse_branch"]["type"] == "DA2"
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=cfg))
    variables = random_variables(jm.init, 21)
    batch = make_batch()
    loss_j, depth_j, ref = jax_step(jm, variables, batch)
    port = PatchRefinerPlus(cfg, device="cpu")
    load_jax_params(port, variables)
    port.train()
    assert port.net.hack_chl == [256] * 5 + [128]
    cf = None
    if strategy == "mean_0_std_1":
        cf = [torch.from_numpy(d).permute(0, 3, 1, 2) for d in hacked_draws(port, batch, np.float32)]
    ld, aux = port.loss(batch, update_stats=True, coarse_features=cf)
    ld["total_loss"].backward()
    loss = float(ld["total_loss"].detach())
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (loss, loss_j)
    depth = aux["depth_pred"].detach().numpy()
    assert depth.shape == depth_j.shape == (2, *HW, 1)
    err = np.abs(depth - depth_j).max() / np.abs(depth_j).max()
    print(f"{name} {strategy}: depth max |port - JAX| / max |JAX|", err)
    assert err <= 1e-4
    errs = grad_errors(port, ref)
    assert sorted(errs) == sorted(k for k in ref if "running_" not in k)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print(f"{name} {strategy}: float32 gradient ||port - JAX|| / ||JAX||", d / n)  # pytest -s
    assert d <= 2e-2 * n
    assert sum(m > 0 for _, m in errs.values()) > 0.9 * len(errs)
    for k, got in stats_of(port).items():
        assert np.abs(got - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k
