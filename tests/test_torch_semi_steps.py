"""Two more PatchRefinerSemi steps with a ``PatchRefinerPlus`` student
against the JAX package on the CPU, at tests/test_torch_semi.py's float32
bars and with its topology and batch: offline, with the SSI + gradient-match
edge loss and the batch's ``pseudo_label``
(``plus_eff_cs_semi_offline_ssigm_ft.py``), and online with the ranking
loss of the main path (``plus_eff_cs_semi_online_ranking_ft.py``), the
port's ranking body fed JAX's own samples: drawn, after JAX's step, from
JAX's pseudo label with its key chain (``fold_in(rng, 7)``, then as
tests/test_torch_semi_losses.py's ``jax_samples`` draws them), under
``jit`` as the step draws them."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models import losses as jl

from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_semi import (
    KEY, RANKING, SSI_GM, build_semi, check_float32_step, plus_student, semi_batch, semi_config,
)
from tests.test_torch_semi_losses import jax_samples
from tests.test_torch_train_e2e import one_bn_group  # noqa: F401 (autouse)


def test_semi_offline_step_float32():
    jm, variables, port = build_semi(semi_config(plus_student(), False, SSI_GM))
    assert port.teacher is None and "teacher" not in variables["params"]
    check_float32_step(jm, variables, port, semi_batch(False))


def test_semi_online_ranking_step_float32():
    jm, variables, port = build_semi(semi_config(plus_student(), True, RANKING))
    batch = semi_batch(True)
    crop_depths = jnp.asarray(np.asarray(batch["crop_depths"], np.float32))
    drawn = {}

    def samples_of(pseudo):
        gt = np.asarray(jax.jit(jl._align_pred)(crop_depths, jnp.asarray(pseudo)))
        drawn.update(jax_samples(jm.edgeloss, pseudo, gt, jax.random.fold_in(KEY, 7)))
        return drawn

    losses = check_float32_step(jm, variables, port, batch, samples_of=samples_of)
    assert drawn["any_edge"].all()
    assert losses["total_loss"] == pytest.approx(losses["sig_fine_loss"] + 0.5 * losses["edge_loss"],
                                                 rel=1e-6)
