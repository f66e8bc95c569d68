"""The port's ``coarse-fusion`` C2F (the GatedConvUnits without their gate:
K5 with ``out=None``, ``models/blocks/dpt.py``) against the JAX package.

The slice of ``tests/test_torch_slice.py`` (the flagship topology over a
tiny BEiT trunk, the full EfficientNet-B5 refiner, a 96x128 frame split
2x2, ``process_num=4``) with ``coarse2fine_type="coarse-fusion"``. One JAX
model is initialised for the module, its variables redrawn with numpy from
a seed and loaded into the port; the port runs on the CPU (plain kernel
versions). Bar (float32): the slice's, max rel < 1e-4 and mean rel < 1e-5.
"""

import numpy as np
import pytest

import jax

from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.models.blocks.dpt import GatedConvUnit
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.ops import gated
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_modules import randomize
from tests.test_torch_slice import assert_rel, slice_config


def fusion_config():
    cfg = slice_config()
    cfg["refiner"]["fusion_model"]["coarse2fine_type"] = "coarse-fusion"
    return cfg


@pytest.fixture(scope="module")
def both():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=fusion_config()))
    variables = randomize(jm.init(jax.random.PRNGKey(0)), seed=23)
    port = PatchRefinerPlus(fusion_config(), device="cpu")
    load_jax_params(port, variables)
    rng = np.random.RandomState(13)
    lr = rng.rand(1, 48, 64, 3).astype(np.float32)
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    return jm, variables, port, lr, hr


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_coarse_fusion_matches_jax(both, mode, monkeypatch):
    jm, variables, port, lr, hr = both
    units = [m for m in port.net.modules() if isinstance(m, GatedConvUnit) and m.fusion]
    assert len(units) == 10 and not any(u.gate for u in units)
    gates = []
    plain = gated.gate_tail_plain

    def spy(f, out, *args):
        gates.append(out is None)
        return plain(f, out, *args)

    monkeypatch.setattr(gated, "gate_tail_plain", spy)
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4)
    # every unit of every chunk ran K5 with the gate off: 10 a chunk
    assert gates and all(gates) and len(gates) % 10 == 0
    assert tuple(depth.shape) == (96, 128)
    assert float(np.std(np.asarray(depth_j))) > 0
    assert_rel(depth.numpy(), depth_j, f"{mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"{mode} coarse_pred")
