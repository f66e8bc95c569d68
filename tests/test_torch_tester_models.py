"""``Tester.run_consistency`` for each model type as the JAX package runs it,
on the CPU.

JAX's ``run_consistency`` runs the model's ``loss`` on a batch of the
crops (``image_lr``, ``crops_image_hr``, ``crop_depths``, ``bboxs``):

- a coarse ``BaselinePretrain`` and an offline ``PatchRefinerSemi`` read
  ``depth_gt`` or ``pseudo_label`` and fail on the missing key, the
  pretraining stage (which reads ``depth_gt`` too) fails earlier, on its
  train-mode BatchNorm; the port raises a ``ValueError`` that names the
  model type and the key;
- an online ``PatchRefinerSemi`` runs its student's loss;
- a fine ``BaselinePretrain`` runs: the port's error equals JAX's within
  rel 1e-4 / abs 1e-5;
- a Depth-Anything-V2 coarse branch takes ``image_lr`` as the loader gives
  it: at sides that are not multiples of 14 (the configs' 384x512, here
  48x64) JAX's DINOv2 fails in a reshape, and the port raises a
  ``ValueError`` that says so; at multiples of 14 (the configs with
  ``network_process_size=[448, 448]``, here 56x84) the errors agree.

The tiny nets are those of tests/test_torch_baseline_pretrain.py,
tests/test_torch_train_slice.py, tests/test_torch_semi.py,
tests/test_torch_da2.py and tests/test_torch_v1.py.
"""

import shutil

import numpy as np
import pytest

import jax
from flax.errors import ModifyScopeVariableError

from patchrefinerv2_tpu.datasets.base import DataLoader as JDataLoader
from patchrefinerv2_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from patchrefinerv2_tpu.evaluation.tester import Tester as JTester
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.evaluation.tester import Tester as PortTester
from patchrefinerv2_torch.models.baseline_pretrain import BaselinePretrain
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.models.patchrefiner_semi import PatchRefinerSemi
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_baseline_pretrain import CASES
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_mobile import random_variables
from tests.test_torch_semi import SSI_GM, plus_student, semi_config
from tests.test_torch_train_slice import pretrain_config
from tests.test_torch_v1 import v1_config


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test with what it wrote."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def consistency(process=(48, 64), raw=(96, 128), patch=(24, 32)):
    """Both packages' loaders of one consistency-mode synthetic frame."""
    kw = dict(mode="train", consistency=True, length=1, image_raw_shape=raw,
              network_process_size=process, patch_raw_shape=patch, overlap=8)
    return JDataLoader(JSynthetic(**kw), batch_size=1, num_prefetch=0), DataLoader(SyntheticDataset(**kw))


def run_both(jm, variables, port, loaders, tmp_path):
    jl, pl = loaders
    want = JTester({}, jm, jl, work_dir=str(tmp_path)).run_consistency(variables, process_num=4)
    got = PortTester({}, port, pl).run_consistency(process_num=4)
    print(f"port {got['consistency']!r} JAX {want['consistency']!r}")  # pytest -s
    assert got["consistency"] > 0
    assert np.isclose(got["consistency"], want["consistency"], rtol=1e-4, atol=1e-5)


# case -> (model type, its config, the key its loss reads, what JAX raises)
CANNOT = {
    "pretraining stage": ("PatchRefinerPlus", lambda: dict(type="PatchRefinerPlus",
                                                           config=pretrain_config(False, (48, 64))),
                          "depth_gt", (ModifyScopeVariableError, "batch_stats")),
    "coarse BaselinePretrain": ("BaselinePretrain", lambda: dict(CASES["zoe_coarse"]), "depth_gt",
                                (KeyError, "depth_gt")),
    "offline PatchRefinerSemi": ("PatchRefinerSemi",
                                 lambda: semi_config(plus_student(), False, SSI_GM), "pseudo_label",
                                 (KeyError, "pseudo_label")),
}


@pytest.mark.parametrize("case", list(CANNOT))
def test_models_whose_loss_reads_another_key_raise(case, tmp_path):
    """JAX fails on the missing key, or for the pretraining stage before it:
    its refiner's BatchNorm runs in train mode, which an immutable apply
    cannot (the port's loss raises for that too without ``update_stats``)."""
    kind, cfg, key, (error, match) = CANNOT[case]
    jm = MODELS.build(cfg())
    variables = random_variables(jm.init, 21)
    jl, pl = consistency()
    with pytest.raises(error, match=match):
        JTester({}, jm, jl, work_dir=str(tmp_path)).run_consistency(variables, process_num=4)
    port = build_model(cfg(), device="cpu")
    with pytest.raises(ValueError, match=f"{kind}'s loss reads .*{key}"):
        PortTester({}, port, pl).run_consistency(process_num=4)


def test_fine_baseline_pretrain_matches_jax(tmp_path):
    cfg = CASES["zoe_fine"]
    jm = MODELS.build(dict(cfg))
    variables = random_variables(jm.init, 21)
    port = BaselinePretrain(cfg, device="cpu")
    load_jax_params(port.net.branch, variables, part="DepthNet")
    run_both(jm, variables, port, consistency(), tmp_path)


def test_da2_consistency_needs_sides_of_multiples_of_14(tmp_path):
    """PatchRefinerPlus with a DA2 coarse branch on a 112x168 frame (24x42
    crops): at 48x64 JAX fails and the port raises, at 56x84 they agree;
    V1 with a DA2 fine branch raises as the flagship does."""
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=da2_slice_config()))
    variables = random_variables(jm.init, 21)
    port = PatchRefinerPlus(da2_slice_config(), device="cpu")
    load_jax_params(port, variables)
    kw = dict(raw=(112, 168), patch=(28, 42))
    jl, pl = consistency((48, 64), **kw)
    with pytest.raises(TypeError, match="reshape"):
        JTester({}, jm, jl, work_dir=str(tmp_path)).run_consistency(variables, process_num=4)
    with pytest.raises(ValueError, match="PatchRefinerPlus with a Depth-Anything-V2 coarse branch .* "
                                         "multiples of 14: got \\(48, 64\\)"):
        PortTester({}, port, pl).run_consistency(process_num=4)
    run_both(jm, variables, port, consistency((56, 84), **kw), tmp_path)
    v1 = build_model(dict(type="PatchRefiner", config=v1_config(da2_slice_config())), device="cpu")
    with pytest.raises(ValueError, match="PatchRefiner with a Depth-Anything-V2"):
        PortTester({}, v1, consistency((48, 64), **kw)[1]).run_consistency(process_num=4)


def test_online_semi_runs_the_students_loss(tmp_path):
    """An online PatchRefinerSemi (a teacher, no pseudo label read) runs:
    its ``depth_pred`` is the student's, so its error is the student's."""
    cfg = semi_config(plus_student(), True, SSI_GM)
    semi = PatchRefinerSemi(cfg, device="cpu")
    _, pl = consistency()
    got = PortTester({}, semi, pl).run_consistency(process_num=4)
    want = PortTester({}, semi.student, pl).run_consistency(process_num=4)
    assert got == want and got["consistency"] > 0
