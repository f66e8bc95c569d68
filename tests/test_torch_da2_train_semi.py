"""``semi_kitti.py``'s Depth-Anything-V2 student and the Depth-Anything
resizer of PatchRefinerPlus's inference, on the port against the JAX
package, on the CPU.

The Semi step: the student of ``patchrefinerv2_dav2/semi_kitti.py`` in the
form of tests/test_torch_da2.py's slice (a ``vitt`` DA2 coarse branch,
``e2e_training`` off, the EfficientNet-B5 refiner, BiDirectionalFusion at
the DA2 widths) at 56x84 patches; offline (no teacher: the batch's
``pseudo_label``), ``mix_loss`` off, the ``ScaleAndShiftInvariantLoss``
edge loss without gradient matching, ``edge_loss_weight`` 1. The port's
student runs with ``remat`` on as the config sets it; JAX's with it off (it
cannot init the config with remat; remat changes no value). One float32
step against ``jax.value_and_grad`` of JAX's ``PatchRefinerSemi.loss``, at
tests/test_torch_semi.py's float32 bars (``check_float32_step``: each loss
max rel <= 1e-5, the depth and the pseudo label at the parity bar, the
student's coarse branch without gradient, the whole gradient within 2e-2
of its norm, each BatchNorm statistic within 1e-4 of its leaf's largest
value).

The resizer: PatchRefinerPlus with that DA2 coarse branch at 48x64 patches
of a 96x128 frame split 2x2, on a 50x84 ``image_lr``. The coarse branch
sees it resized (bilinear, align corners) to 56x84, the patches are
crop-resized to 42x70 and their depths resized back to 48x64
(``patchrefinerplus.py:440-449, 628-631, 671-674``). m1, m2 and r8
(process_num 4: two random chunks at JAX's starts, injected) against JAX's
``infer``: the coarse depth max rel < 1e-4 and mean < 1e-5; the depth,
which is 0 and near it at some pixels here (the ``offset_fine`` output at
random weights), max |port - JAX| <= 1e-5 of its magnitude (measured
1.7e-6) and mean rel < 1e-5. The refiner runs here without its coarse condition and with the
``offset_fine`` target: in the configs' form (the coarse depth's roi
concatenated to the patch and added to the output) the JAX package's
``infer`` cannot take patches whose sides are not multiples of 14, the
roi being at the coarse map's size; no DA2 config has such patches
(448x448). tests/test_torch_da2.py holds the configs' form with the
coarse input rounded.
"""

import numpy as np
import pytest

import jax

from patchrefinerv2_tpu.models.tiling import TileCfg as JTileCfg
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.models.patchrefiner_semi import PatchRefinerSemi
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_eval import jax_random_starts
from tests.test_torch_mobile import random_variables
from tests.test_torch_semi import check_float32_step, semi_config
from tests.test_torch_slice import assert_rel
from tests.test_torch_train_e2e import make_batch, one_bn_group  # noqa: F401 (autouse)

SSI = dict(type="ScaleAndShiftInvariantLoss", only_missing_area=False, grad_matching=False)


def student(remat: bool) -> dict:
    return dict(type="PatchRefinerPlus", config=dict(da2_slice_config(), e2e_training=False,
                                                     remat=remat))


def test_da2_semi_student_step_float32():
    cfg = dict(semi_config(student(False), False, SSI), mix_loss=False, edge_loss_weight=1.0)
    jm = MODELS.build(dict(cfg))
    variables = random_variables(jm.init, 21)
    port = PatchRefinerSemi(dict(cfg, model_cfg_student=student(True)), device="cpu")
    load_jax_params(port, variables, part="PatchRefinerSemi")
    assert port.teacher is None and port.student.net.remat and port.student.resizer_da
    batch = make_batch(hw=(56, 84))
    batch["pseudo_label"] = 1.0 + 15.0 * np.random.RandomState(8).rand(2, 56, 84, 1)
    losses = check_float32_step(jm, variables, port, batch)
    assert losses["total_loss"] == pytest.approx(losses["sig_fine_loss"] + losses["edge_loss"], rel=1e-6)


def resizer_config() -> dict:
    cfg = dict(da2_slice_config(), patch_process_shape=[48, 64], image_raw_shape=[96, 128],
               strategy_refiner_target="offset_fine")
    cfg["refiner"]["fine_branch"]["coarse_condition"] = False
    return cfg


@pytest.fixture(scope="module")
def resizer_both():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=resizer_config()))
    variables = random_variables(jm.init, 17)
    port = PatchRefinerPlus(resizer_config(), device="cpu")
    load_jax_params(port, variables)
    rng = np.random.RandomState(12)
    lr = rng.rand(1, 50, 84, 3).astype(np.float32)
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    return jm, variables, port, lr, hr


@pytest.mark.parametrize("mode", ["m1", "m2", "r8"])
def test_da2_resizer_infer_matches_jax(resizer_both, mode):
    jm, variables, port, lr, hr = resizer_both
    assert port.patch_input_shape == (42, 70) and port.coarse_input_shape((50, 84)) == (56, 84)
    key = jax.random.PRNGKey(5)
    starts = None
    if mode == "r8":
        starts = jax_random_starts(key, JTileCfg((96, 128), (2, 2), (48, 64)), 4, 2)
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4, seed=key)
    shapes = []
    hook = port.net.refiner_fine_branch.register_forward_hook(
        lambda m, i, o: shapes.append(tuple(i[0].shape[2:])))
    try:
        depth, coarse = port.infer(lr, hr, mode, process_num=4, random_starts=starts)
    finally:
        hook.remove()
    assert set(shapes) == {(42, 70)}
    assert tuple(coarse.shape) == (1, 56, 84, 1)
    assert tuple(depth.shape) == (96, 128)  # the raw canvas and the reensemble one alike
    depth_j = np.asarray(depth_j)
    assert float(np.std(depth_j)) > 0
    err = np.abs(depth.numpy() - depth_j)
    print(f"{mode} depth: max |port - JAX| / max |JAX| {err.max() / np.abs(depth_j).max():.3g}")
    assert err.max() <= 1e-5 * np.abs(depth_j).max()
    assert (err / np.maximum(np.abs(depth_j), 1e-3)).mean() < 1e-5
    assert_rel(coarse.numpy(), coarse_j, f"{mode} coarse_pred")
