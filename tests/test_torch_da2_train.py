"""The port's stage-3 training step with a Depth-Anything-V2 coarse branch
(``patchrefinerv2_dav2/plus_eff_u4k.py`` and its ``e2e_training`` forms)
against the JAX package, on the CPU, and the Depth-Anything resizer's
rounding.

tests/test_torch_da2.py's slice (a ``vitt`` DINOv2 with the DPT head, the
EfficientNet-B5 refiner with its coarse condition, BiDirectionalFusion at
the DA2 widths) at 56x84 patches: a 4x6 patch grid, so the DINOv2 position
embedding goes through the bicubic K2 (and, with ``e2e_training``, its
backward); the 3x5 grid of 42x70 makes the float32 step ill-conditioned on
both sides (tests/test_torch_baseline_pretrain.py). One JAX model a case,
its variables from ``jax.eval_shape`` of its init with every leaf drawn
with numpy, loaded
into the port through ``load_jax_params``; a batch of two 56x84 images, two
crops with their boxes and 72x96 crop depths from a seed
(tests/test_torch_train_e2e.py's ``make_batch``).

One step's loss dict, its depth, its coarse prediction, every gradient leaf
and the BatchNorm statistics after it, against ``jax.value_and_grad`` of
JAX's ``PatchRefinerPlus.loss`` with ``mutable=["batch_stats"]``:

- float32, ``e2e_training`` off and on: each loss max rel <= 1e-5; the
  depth max rel < 1e-4 and mean < 1e-5 (``assert_rel``); the coarse
  prediction within 1e-5 of its magnitude; the whole gradient within 1e-3
  of its norm (measured 1.3e-5 on, 3.6e-5 off); each BatchNorm statistic
  within 1e-4 of its leaf's largest value (measured 6.7e-5). Per leaf the
  float32 step is ill-conditioned (the train-mode BatchNorm of the
  refiner's deepest maps, tests/test_torch_train_e2e.py): 580 of 763
  leaves differ by more than 1e-4 of their norm on both sides' float32.
  With it off, the coarse leaves' gradients are zero on both sides (the
  port runs the branch under no gradient: none).
- float64 (``slow``), ``e2e_training`` on: each loss max rel <= 1e-5; the
  whole gradient within 1e-4 of its norm (measured 3.5e-6) and each leaf
  ||port - JAX|| / ||JAX|| <= 2e-3, a leaf's norm floored at 1e-6 of the
  whole gradient's (measured 5.0e-4, a C2F fusion conv); the gradient
  reaches every coarse leaf. Not stage 3's ZoeDepth bar of 1e-4 a leaf
  (tests/test_torch_train_e2e.py): both sides take the losses of float32
  predictions (``patchrefinerplus.py:543-544``), so the output gradient
  agrees to float32's rounding, and this step's train-mode BatchNorm
  amplifies it (measured: 461 of 763 leaves over 1e-4 in float64, 580 in
  float32; at 112x168 patches 490; with JAX's float32 islands -- its
  attention, resize, roi_align and LayerNorms -- made float64, 499, while
  the DA2 network alone then agrees to 1.4e-15). The Semi steps' float64
  bars are looser for the same reason (tests/test_torch_semi.py).

The loss takes ``image_lr`` as the batch gives it, as JAX's does, so sides
that are not multiples of 14 raise in the port's DINOv2; inference rounds
them (tests/test_torch_da2.py, tests/test_torch_da2_train_semi.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.patchrefinerplus import _da_round
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.models.backbones.dpt import da_round
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_mobile import random_variables
from tests.test_torch_slice import assert_rel
from tests.test_torch_train_e2e import assert_losses, make_batch, one_bn_group  # noqa: F401 (autouse)
from tests.test_torch_train_slice import grad_errors, stats_of

HW = (56, 84)


def stage3_config(e2e: bool) -> dict:
    return dict(da2_slice_config(), e2e_training=e2e)


@pytest.fixture(scope="module")
def cases():
    """``cases(e2e)``: (the JAX model, its random variables), built once a module."""
    cache = {}

    def get(e2e):
        if e2e not in cache:
            jm = MODELS.build(dict(type="PatchRefinerPlus", config=stage3_config(e2e)))
            cache[e2e] = jm, random_variables(jm.init, 21)
        return cache[e2e]

    return get


def jax_step(jm, variables, batch, dtype):
    """(loss dict, depth, coarse prediction, gradients and batch stats after
    the step as the port's state-dict names) of JAX's stage-3 loss."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        b = {k: jnp.asarray(np.asarray(x, dtype)) for k, x in batch.items()}

        def loss(p):
            ld, aux = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, b,
                              mutable=["batch_stats"])
            return ld["total_loss"], (ld, aux["depth_pred"], aux["coarse_prediction"],
                                      aux["variables"]["batch_stats"])

        (_, (ld, depth, coarse, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v["params"])
        return ({k: float(x) for k, x in ld.items()}, np.asarray(depth), np.asarray(coarse),
                jax_to_state_dict({"params": jax.device_get(grads), "batch_stats": jax.device_get(stats)}))


def port_step(e2e, variables, batch, dtype):
    port = PatchRefinerPlus(stage3_config(e2e), device="cpu")
    load_jax_params(port, variables)
    port.net.to(dtype)
    port.train()
    ld, aux = port.loss(batch, update_stats=True)
    ld["total_loss"].backward()
    return port, {k: float(v.detach()) for k, v in ld.items()}, aux


@pytest.mark.parametrize("e2e", [False, True], ids=["e2e_off", "e2e_on"])
def test_da2_stage3_step_float32(cases, e2e):
    jm, variables = cases(e2e)
    batch = make_batch(hw=HW)
    ref_losses, ref_depth, ref_coarse, ref = jax_step(jm, variables, batch, np.float32)
    port, losses, aux = port_step(e2e, variables, batch, torch.float32)
    assert_losses(losses, ref_losses)
    depth = aux["depth_pred"].detach().numpy()
    assert depth.shape == (2, *HW, 1)
    assert_rel(depth, ref_depth, "DA2 stage-3 depth")
    coarse = aux["coarse_prediction"].detach().numpy()
    assert coarse.shape == ref_coarse.shape == (2, *HW, 1)
    assert np.abs(coarse - ref_coarse).max() <= 1e-5 * np.abs(ref_coarse).max()
    errs = grad_errors(port, ref)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print("float32 gradient ||port - JAX|| / ||JAX||", d / n)  # shown with pytest -s
    assert d <= 1e-3 * n
    for k, p in port.net.named_parameters():
        if k.startswith("coarse_branch."):
            # off: JAX's stop_gradient gives zeros, the port no gradient
            assert (p.grad is not None) == e2e and (errs[k][1] > 0) == e2e, k
        else:
            assert p.grad is not None, k
    if e2e:  # the bicubic K2 backward of the 4x6 grid's position embedding
        assert errs["coarse_branch.pretrained.pos_embed"][1] > 1e-6 * n
    for k, got in stats_of(port).items():
        assert np.abs(got - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k


@pytest.mark.slow  # composed parity, as the repo marks it: XLA's float64 step
def test_da2_stage3_step_matches_jax_float64(cases):
    jm, variables = cases(True)
    batch = make_batch(hw=HW)
    ref_losses, _, _, ref = jax_step(jm, variables, batch, np.float64)
    port, losses, _ = port_step(True, variables, batch, torch.float64)
    assert_losses(losses, ref_losses)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print("float64 worst gradient leaf", worst, errs[worst])
    assert np.sqrt(sum(d ** 2 for d, _ in errs.values())) <= 1e-4 * total
    for k, (d, n) in errs.items():
        assert d <= 2e-3 * max(n, 1e-6 * total), (k, d, n)
    assert all(n > 0 for k, (_, n) in errs.items() if k.startswith("coarse_branch."))


def test_da2_stage3_sides_not_multiple_of_14_raise(cases):
    """The loss does not resize ``image_lr`` (JAX's neither): a 50x84 image
    raises in the port's DINOv2, with the rounding it needs in the message."""
    _, variables = cases(True)
    port = PatchRefinerPlus(stage3_config(True), device="cpu")
    load_jax_params(port, variables)
    batch = make_batch(hw=HW)
    with pytest.raises(ValueError, match="multiples of 14"):
        port.train().loss(dict(batch, image_lr=batch["image_lr"][:, :50]), update_stats=True)


def test_da_round_matches_jax():
    """``da_round`` (the one helper BaselinePretrain and PatchRefinerPlus
    share) is JAX's ``_da_round`` on every pair of sides from 1 to 600,
    halves (7, 21, ...) rounded to even as Python's ``round`` does."""
    sides = range(1, 601)
    got = [da_round((h, w)) for h in sides for w in (h, 601 - h)]
    want = [_da_round((h, w)) for h in sides for w in (h, 601 - h)]
    assert got == want
    assert da_round((384, 512)) == (378, 518) and da_round((7, 21)) == (0, 28)
    assert all(s % 14 == 0 for hw in got for s in hw)
