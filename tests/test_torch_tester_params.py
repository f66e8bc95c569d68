"""``Tester.model_complexity``'s ``params`` against the JAX package's count,
the elements of its ``params`` leaves (``batch_stats`` left out), on the CPU.

- The tiny flagship (tests/test_torch_slice.py), DA2
  (tests/test_torch_da2.py), Mobile (tests/test_torch_mobile.py) and V1
  (tests/test_torch_v1.py) nets: every port parameter is loaded from a JAX
  parameter and no JAX parameter lands in a port buffer (BatchNorm's
  statistics do, from ``batch_stats``), and the elements agree.
- The configs at their full widths (the flagship, DA2, Mobile and V1): the
  elements of the port's net's parameters, built on the meta device, are
  JAX's count from ``jax.eval_shape`` of its init.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax

from patchrefinerv2_tpu.config import Config as JConfig
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.models.patchrefiner import build_model
from patchrefinerv2_torch.models.patchrefinerplus import PRPlusNet
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_da2 import da2_slice_config
from tests.test_torch_mobile import mobile_config, random_variables
from tests.test_torch_slice import slice_config
from tests.test_torch_v1 import v1_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {"flagship": ("PatchRefinerPlus", slice_config), "da2": ("PatchRefinerPlus", da2_slice_config),
           "mobile": ("PatchRefinerPlus", mobile_config), "v1": ("PatchRefiner", v1_config)}


def leaf_elements(tree) -> int:
    return sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_are_jax_params(name):
    """The port's parameters are JAX's ``params``, tensor for tensor: the
    keys that ``jax_to_state_dict`` fills from ``params`` (``batch_stats``
    set to nan) are the port's parameters, and their elements JAX's count."""
    kind, config = CONFIGS[name]
    variables = random_variables(MODELS.build(dict(type=kind, config=config())).init, 21)
    port = build_model(dict(type=kind, config=config()), device="cpu")
    load_jax_params(port, variables)
    stats = jax.tree_util.tree_map(lambda x: np.full_like(x, np.nan), variables.get("batch_stats", {}))
    sd = jax_to_state_dict({"params": variables["params"], "batch_stats": stats})
    from_params = {k for k, v in sd.items() if np.isfinite(v).all()}
    named = dict(port.net.named_parameters())
    assert from_params == set(named)
    assert set(sd) - from_params <= {k for k, _ in port.net.named_buffers()}
    assert sum(p.numel() for p in named.values()) == leaf_elements(variables["params"])


FULL = ["configs/patchrefinerv2_zoedepth/v2_eff_u4k.py", "configs/patchrefinerv2_dav2/plus_eff_u4k.py",
        "configs/patchrefinerv2_zoedepth/v2_mobile_u4k.py", "configs/patchrefiner_zoedepth/pr_u4k.py"]


@pytest.mark.parametrize("config", FULL, ids=lambda p: pathlib.Path(p).stem)
def test_full_width_params_equal_jax(config):
    """``model_complexity``'s ``params`` (the elements of the net's
    parameters) at the config's widths is JAX's count of its ``params``
    leaves (the flagship: 413,164,183)."""
    jm = MODELS.build(JConfig.fromfile(str(ROOT / config)).model)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    cfg = Config.fromfile(str(ROOT / config))
    with torch.device("meta"):
        net = PRPlusNet(cfg.model.config, v1=cfg.model.get("type") == "PatchRefiner")
    assert sum(p.numel() for p in net.parameters()) == want
