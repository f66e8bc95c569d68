"""PatchRefinerSemi with a PatchRefiner V1 student against the JAX package
on the CPU: tests/test_torch_semi.py's step with tests/test_torch_v1.py's
slice (the tiny BEiT ZoeDepth as the coarse and the fine branch, FusionUnet)
as the student and, online, the teacher. Online with the SILog edge loss
(``patchrefiner_zoedepth_online_pesudo/pr_sigloss_cs.py``), offline with
the MiDaS SSI loss and the batch's pseudo label
(``patchrefiner_zoedepth_offline_pesudo/pr_ssi_midas_cs.py``); the bars
are tests/test_torch_semi.py's float32 ones. V1 has no BatchNorm."""

import pytest

from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_semi import build_semi, check_float32_step, semi_batch, semi_config
from tests.test_torch_v1 import v1_config

SILOG = dict(type="SILogLoss")
SSI = dict(type="ScaleAndShiftInvariantLoss", only_missing_area=False, grad_matching=False)


@pytest.mark.parametrize("online", [True, False], ids=["online_silog", "offline_ssi"])
def test_semi_v1_step_float32(online):
    cfg = semi_config(dict(type="PatchRefiner", config=v1_config()), online, SILOG if online else SSI)
    jm, variables, port = build_semi(cfg)
    assert (port.teacher is not None) == online
    check_float32_step(jm, variables, port, semi_batch(online))
