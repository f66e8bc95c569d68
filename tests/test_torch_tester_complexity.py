"""The port's ``Tester.model_complexity`` and ``Tester.vis_feat`` against
the JAX package, on the CPU (every kernel wrapper takes its plain version).

- ``params`` is JAX's count, the elements of the ``params`` leaves, on the
  tiny flagship of tests/test_torch_slice.py (other nets and the full
  widths: tests/test_torch_tester_params.py).
- ``flops`` is the port's own count (XLA's cost analysis has no PyTorch
  counterpart): each kernel counts its products once, by hand counts at a
  K9, a K5, a K3 and a K10 site, and the aten ops of its plain version add
  nothing; on the CPU the plain versions compute the kernels' products, so
  the frame's count is ``FlopCounterMode``'s of the all-plain frame, and the
  int8 mode (K10 in place of the convolutions it serves) leaves it as it is.
- ``vis_feat`` writes as many maps as JAX's (its ``net.apply`` jitted here,
  which changes nothing but the time), and the coarse levels' and the
  coarse depth's channel means agree to max rel < 1e-4 of each map's
  largest magnitude.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax

from patchrefinerv2_tpu.datasets.base import DataLoader as JDataLoader
from patchrefinerv2_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from patchrefinerv2_tpu.evaluation.tester import Tester as JTester
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils import color as jcolor

from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.evaluation import tester as tester_module
from patchrefinerv2_torch.evaluation.tester import Tester as PortTester
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.ops import _flops, attention, gate_tail, quant_conv, tail_conv
from patchrefinerv2_torch.ops.attention import attention_plain
from patchrefinerv2_torch.ops.gated import gate_tail_plain
from patchrefinerv2_torch.ops.tail_conv import tail_conv_plain
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import random_variables
from tests.test_torch_slice import slice_config

@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test with what it wrote."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def flagship():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=slice_config()))
    variables = random_variables(jm.init, 21)
    port = PatchRefinerPlus(slice_config(), device="cpu")
    load_jax_params(port, variables)
    return jm, variables, port


def leaf_elements(tree) -> int:
    return sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(tree))


def test_kernel_counts_are_hand_counts():
    """Each product kernel counts its function's products once: a K9 3x3 and
    1x1 site (C2F's ``output_conv2`` and ``output_conv3`` of a 4-patch chunk
    at 48x64), a K5 site (a 256-channel GatedConvUnit at 24x32), K3 (a BEiT
    block of 4 heads over 12 + 1 tokens) and a K10 3x3 site; the counter
    sees none of their plain versions, which compute those products."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.rand(shape, generator=g)

    q, k, v = r(4, 4, 13, 16), r(4, 4, 13, 16), r(4, 4, 13, 16)
    kq = (torch.rand((8, 16, 3, 3), generator=g) * 200 - 100).to(torch.int8)
    calls = [
        ("tail_conv", lambda: tail_conv([r(4, 48, 64, 128)], r(32, 128, 3, 3), r(32), act="relu"),
         2 * 4 * 48 * 64 * 32 * 128 * 9),
        ("tail_conv", lambda: tail_conv([r(4, 48, 64, 16), r(4, 48, 64, 16)], r(1, 32, 1, 1), r(1),
                                        ln=None), 2 * 4 * 48 * 64 * 1 * 32),
        ("gate_tail", lambda: gate_tail(r(4, 24, 32, 256), r(4, 24, 32, 256), r(256, 256, 1, 1),
                                        r(256), r(256)), 2 * 4 * 24 * 32 * 256 * 256),
        ("attention", lambda: attention(q, k, v, 0.25), 2 * 2 * 4 * 4 * 13 * 13 * 16),
        ("quant_conv", lambda: quant_conv([r(2, 12, 16, 16)], kq, r(16) + 0.1, r(8) * 0.01),
         2 * 2 * 12 * 16 * 8 * 16 * 9),
    ]
    for name, call, want in calls:
        with _flops.counting() as counts, FlopCounterMode(display=False) as counter:
            call()
        assert counts == {name: want} and counter.get_total_flops() == 0, (name, counts)
    plains = [(lambda: tail_conv_plain([r(4, 48, 64, 128)], r(32, 128, 3, 3), r(32), None, None,
                                       "relu", False, 1e-6), calls[0][2]),
              (lambda: gate_tail_plain(r(4, 24, 32, 256), None, r(256, 256), r(256), r(256)),
               calls[2][2]),
              (lambda: attention_plain(q, k, v, 0.25, None, None), calls[3][2])]
    for call, want in plains:
        with FlopCounterMode(display=False) as counter:
            call()
        assert counter.get_total_flops() == want


def test_model_complexity_counts_each_product_once(flagship, monkeypatch):
    """The frame's count in m1 and r8 (rN's starts from a generator seeded
    0) is ``FlopCounterMode``'s of the all-plain frame, with the kernels'
    share (K3, K5, K9) counted by the kernels; the dynamic int8 mode (its
    sites served at these sizes: the pixel gate 0) counts the same; ``params`` is JAX's count. The
    keys are JAX's but ``bytes_accessed``."""
    _, variables, port = flagship
    tester = PortTester({}, port, None)
    shapes = dict(image_lr_shape=(1, 48, 64, 3), image_hr_shape=(1, 96, 128, 3), process_num=4)
    seen = []
    add = _flops.add
    monkeypatch.setattr(_flops, "add", lambda n, ops: seen.append(n) or add(n, ops))
    for mode in ("m1", "r8"):
        got = tester.model_complexity(cai_mode=mode, **shapes)
        assert sorted(got) == ["flops", "params"]
        assert got["params"] == leaf_elements(variables["params"])
        with FlopCounterMode(display=False) as counter, torch.inference_mode():
            port.infer(torch.zeros(1, 48, 64, 3), torch.zeros(1, 96, 128, 3), mode, 4,
                       generator=torch.Generator().manual_seed(0))
        assert got["flops"] == counter.get_total_flops() > 0, mode
        assert {"attention", "gate_tail", "tail_conv"} <= set(seen)
    exact = tester.model_complexity(cai_mode="m1", **shapes)["flops"]
    seen.clear()
    port.set_int8(None, "dynamic", force=True, min_hw=0)
    try:
        assert tester.model_complexity(cai_mode="m1", **shapes)["flops"] == exact
        assert "quant_conv" in seen
    finally:
        port.set_int8(None)


@pytest.fixture
def jitted_apply(monkeypatch):
    """The JAX net's ``apply`` under ``jax.jit`` (its Python and
    static arguments closed over): ``vis_feat`` runs it eagerly, ~1 min on
    this CPU."""

    def patch(net):
        apply = net.apply

        def jitted(variables, *args, **kw):
            arrays = [a for a in args if hasattr(a, "shape")]

            def fn(v, *xs):
                it = iter(xs)
                return apply(v, *[next(it) if hasattr(a, "shape") else a for a in args], **kw)
            return jax.jit(fn)(variables, *arrays)

        monkeypatch.setattr(net, "apply", jitted, raising=False)

    return patch


def saved(monkeypatch, module):
    """Record each map ``save_colored`` writes through ``module``: file name -> array."""
    maps, save = {}, module.save_colored

    def recording(arr, path, *a, **k):
        maps[os.path.basename(path)] = np.asarray(arr, np.float64)
        return save(arr, path, *a, **k)

    monkeypatch.setattr(module, "save_colored", recording)
    return maps


def test_vis_feat_matches_jax(flagship, jitted_apply, monkeypatch, tmp_path):
    jm, variables, port = flagship
    kw = dict(mode="train", length=1, image_raw_shape=(96, 128), network_process_size=(48, 64),
              patch_raw_shape=(48, 64))
    jbatch = next(iter(JDataLoader(JSynthetic(**kw), batch_size=1, num_prefetch=0)))
    batch = next(iter(DataLoader(SyntheticDataset(**kw))))
    jitted_apply(jm.net)
    jmaps, pmaps = saved(monkeypatch, jcolor), saved(monkeypatch, tester_module)
    jdir = JTester({}, jm, None, work_dir=str(tmp_path)).vis_feat(variables, jbatch,
                                                                  out_dir=str(tmp_path / "jax"))
    pdir = PortTester({}, port, None).vis_feat(batch, out_dir=str(tmp_path / "port"))
    jfiles, pfiles = sorted(os.listdir(jdir)), sorted(os.listdir(pdir))
    print(len(jfiles), jfiles, len(pfiles), pfiles)  # pytest -s
    assert len(pfiles) == len(jfiles) == 22 and sum(f.startswith("fusion_") for f in pfiles) == 15
    coarse = [f"coarse_lvl{i}_mean.png" for i in range(6)] + ["coarse_pred.png"]
    assert [f for f in pfiles if f.startswith("coarse")] == coarse
    for name in coarse:
        d = np.abs(pmaps[name] - jmaps[name]).max() / np.abs(jmaps[name]).max()
        assert d < 1e-4, (name, d)


def test_vis_feat_caps_and_removes_its_hooks(flagship, monkeypatch, tmp_path):
    """``max_maps`` caps the maps (the coarse depth besides); the hooks go
    when the training forward raises too."""
    _, _, port = flagship
    batch = next(iter(DataLoader(SyntheticDataset(mode="train", length=1, image_raw_shape=(96, 128),
                                                  network_process_size=(48, 64),
                                                  patch_raw_shape=(48, 64)))))
    out = PortTester({}, port, None).vis_feat(batch, out_dir=str(tmp_path / "cap"), max_maps=8)
    assert len(os.listdir(out)) == 9
    assert sum(f.startswith("fusion_") for f in os.listdir(out)) == 2

    def raising(*a, **k):
        raise RuntimeError("forward failed")

    monkeypatch.setattr(port.net, "train_forward", raising)
    with pytest.raises(RuntimeError, match="forward failed"):
        PortTester({}, port, None).vis_feat(batch, out_dir=str(tmp_path / "err"))
    assert not any(m._forward_hooks or m._forward_pre_hooks for m in port.net.modules())
    assert not port.net.training
