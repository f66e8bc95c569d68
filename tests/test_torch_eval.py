"""The port's rN tiled inference and its ``Tester.run`` against the JAX package.

The tiny flagship of tests/test_torch_slice.py (one JAX model initialised for
the module, its variables redrawn from a seed and loaded into the port),
with ``process_num=4`` on the CPU, where every kernel wrapper takes its plain
version.

- rN: the random starts of the JAX run come from ``random_pass_starts``
  under the key-split sequence of patchrefinerplus.py:686-689 and are
  injected into the port through ``random_starts=``. Bar (float32): max rel
  < 1e-4 and mean rel < 1e-5, relative to |JAX| floored at 1e-3.
- ``Tester.run`` over a 2-image ``SyntheticDataset`` at a 120x160 frame
  split 2x2 (so the 96x128 reensemble depth is resized to the gt shape), m1
  and m2: every metric within rel 1e-4 (the port resizes in float32 where
  the JAX package resizes in float64; the a1..a3 fractions must be equal).
"""

import numpy as np
import pytest
import torch

import jax

from patchrefinerv2_tpu.datasets.base import DataLoader as JDataLoader
from patchrefinerv2_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from patchrefinerv2_tpu.evaluation.tester import Tester as JTester
from patchrefinerv2_tpu.models.tiling import TileCfg as JTileCfg, random_pass_starts as j_starts
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.evaluation.tester import Tester as TorchTester
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.models.tiling import TileCfg, random_pass_boxes, random_pass_starts
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_modules import randomize
from tests.test_torch_slice import assert_rel, slice_config


@pytest.fixture(scope="module")
def both():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=slice_config()))
    variables = randomize(jm.init(jax.random.PRNGKey(0)), seed=21)
    port = PatchRefinerPlus(slice_config(), device="cpu")
    load_jax_params(port, variables)
    return jm, variables, port


def jax_random_starts(key, tile_cfg, process_num, iters):
    """The starts of the JAX rN loop: ``key, sub = split(key)`` per iteration."""
    out = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        starts, _ = j_starts(sub, tile_cfg, process_num)
        out.append(np.asarray(starts))
    return np.stack(out)


def test_random_pass_starts_ranges_and_boxes():
    tc = TileCfg((96, 128), (2, 2), (48, 64))
    g = torch.Generator().manual_seed(3)
    starts = np.stack([random_pass_starts(g, tc, 4) for _ in range(50)])
    assert starts.dtype == np.int32 and starts.shape == (50, 4, 2)
    assert starts[..., 0].min() >= 0 and starts[..., 0].max() < 96 - 48
    assert starts[..., 1].min() >= 0 and starts[..., 1].max() < 128 - 64
    assert (starts[..., 1] == starts[:, :1, 1]).all()  # one w start per call
    assert len(np.unique(starts[..., 0])) > 4
    # the boxes are the JAX function's for the same starts
    key = jax.random.PRNGKey(7)
    js, jb = j_starts(key, JTileCfg((96, 128), (2, 2), (48, 64)), 4)
    np.testing.assert_array_equal(random_pass_boxes(tc, np.asarray(js)), np.asarray(jb))


@pytest.mark.parametrize("mode", ["r8"])
def test_rn_matches_jax_with_injected_starts(both, mode):
    jm, variables, port = both
    rng = np.random.RandomState(11)
    lr = rng.rand(1, 48, 64, 3).astype(np.float32)
    hr = rng.rand(1, 96, 128, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    depth_j, coarse_j = jm.infer(variables, lr, hr, cai_mode=mode, process_num=4, seed=key)
    starts = jax_random_starts(key, jm.tile_cfg, 4, int(mode[1:]) // 4)
    depth, coarse = port.infer(lr, hr, mode, process_num=4, random_starts=starts)
    assert tuple(depth.shape) == (96, 128)
    assert_rel(depth.numpy(), depth_j, f"{mode} depth")
    assert_rel(coarse.numpy(), coarse_j, f"{mode} coarse_pred")
    # the generator path draws its own starts: another map at the same shape
    d_gen, _ = port.infer(lr, hr, mode, process_num=4, generator=torch.Generator().manual_seed(1))
    assert tuple(d_gen.shape) == (96, 128) and torch.isfinite(d_gen).all()
    with pytest.raises(ValueError, match="random starts"):
        port.infer(lr, hr, mode, process_num=4, random_starts=starts[:1])


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_tester_run_matches_jax(both, mode, tmp_path):
    jm, variables, port = both
    kw = dict(length=2, image_raw_shape=(120, 160), network_process_size=(48, 64))
    jt = JTester({}, jm, JDataLoader(JSynthetic(mode="infer", **kw), batch_size=1, num_prefetch=0),
                 work_dir=str(tmp_path))
    tile = dict(cai_mode=mode, process_num=4, image_raw_shape=(120, 160), patch_split_num=(2, 2))
    ref = jt.run(variables, **tile)
    got = TorchTester({}, port, DataLoader(SyntheticDataset(**kw))).run(**tile)
    assert sorted(got) == sorted(ref) and len(ref) == 9
    for k in ("a1", "a2", "a3"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    for k, v in ref.items():
        print(f"{mode} {k}: port {got[k]!r} JAX {v!r}")  # shown with pytest -s
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)


def test_tester_save_is_not_ported(both):
    with pytest.raises(NotImplementedError):
        TorchTester({}, both[2], None, save=True)
