"""The port's ``Tester.run_consistency``, ``benchmark`` and ``show_gts``
against the JAX package's ``Tester``.

The tiny flagship of tests/test_torch_slice.py and the tiny PatchRefiner V1
of tests/test_torch_v1.py (JAX variables from ``jax.eval_shape`` of the
init, every leaf drawn with numpy from a seed, loaded into the port through
``load_jax_params``), on the CPU, where every kernel wrapper takes its
plain version. The consistency data: two consistency-mode
``SyntheticDataset`` frames of 96x128 (both packages' readers, equal draws),
a 4x4 grid of 24x32 crops overlapping by 8 pixels, each resized to 48x64.

- ``run_consistency``: the port's error equals JAX's within rel 1e-4 / abs
  1e-5 (the bar of JAX's own test, tests/test_tester_modes.py:88-130), for
  the flagship and for V1; the port's chunks equal a crop-by-crop loop of
  its loss; ``evaluate_consistency`` equals JAX's; a dataset without the
  crop grid raises in both.
- ``benchmark``: ``benchmark.txt`` has JAX's four lines (a stub model
  times JAX's loop), each frame draws from a new generator seeded 0.
- ``show_gts``: the same PNGs as JAX's, one per image with ground truth.

tests/test_torch_tester_complexity.py holds ``model_complexity`` and
``vis_feat``; tests/test_torch_tester_models.py the other model types.
"""

import os
import shutil
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patchrefinerv2_tpu.datasets.base import DataLoader as JDataLoader, DepthDataset as JDepthDataset
from patchrefinerv2_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from patchrefinerv2_tpu.evaluation.tester import Tester as JTester
from patchrefinerv2_tpu.ops.resize import resize as jresize
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.datasets.base import DataLoader, DepthDataset
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.evaluation.tester import Tester as PortTester
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.ops.resize import resize
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_mobile import random_variables
from tests.test_torch_slice import slice_config
from tests.test_torch_v1 import build_v1, v1_config

CONSISTENCY = dict(mode="train", consistency=True, length=2, image_raw_shape=(96, 128),
                   network_process_size=(48, 64), patch_raw_shape=(24, 32), overlap=8)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test with what it wrote."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def models():
    """``models(name)``: (the JAX model, its random variables, the port with
    them), built once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "flagship":
                jm = MODELS.build(dict(type="PatchRefinerPlus", config=slice_config()))
                variables = random_variables(jm.init, 21)
                port = PatchRefinerPlus(slice_config(), device="cpu")
                load_jax_params(port, variables)
                cache[name] = jm, variables, port
            else:
                cache[name] = build_v1(v1_config())
        return cache[name]

    return get


def loaders(**kw):
    return (JDataLoader(JSynthetic(**kw), batch_size=1, num_prefetch=0),
            DataLoader(SyntheticDataset(**kw)))


@pytest.mark.parametrize("name", ["flagship", "v1"])
def test_run_consistency_matches_jax(models, name, tmp_path):
    """The error, and with ``save`` each frame's mosaic of the crops' centres."""
    jm, variables, port = models(name)
    jl, pl = loaders(**CONSISTENCY)
    want = JTester({}, jm, jl, work_dir=str(tmp_path / "jax"), save=True).run_consistency(
        variables, process_num=4)
    got = PortTester({}, port, pl, work_dir=str(tmp_path / "port"), save=True).run_consistency(
        process_num=4)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "synthetic_0000.png", "synthetic_0001.png"]
    print(f"{name}: port {got['consistency']!r} JAX {want['consistency']!r}")  # pytest -s
    assert sorted(got) == sorted(want) == ["consistency", "consistency_error"]
    assert got["consistency"] == got["consistency_error"] > 0
    assert np.isclose(got["consistency"], want["consistency"], rtol=1e-4, atol=1e-5)


def test_run_consistency_chunks_equal_a_per_crop_loop(models, monkeypatch):
    """Chunks of ``process_num`` crops (its largest divisor of the 16 crops:
    2 for 3) give the reference's crop-by-crop loop (tester.py:228-244):
    each crop's loss alone, its depth resized to the crop with bilinear
    align corners, then the upper and left strips' mean absolute difference."""
    _, _, port = models("flagship")
    ds = SyntheticDataset(**dict(CONSISTENCY, length=1))
    sizes, loss = [], port.loss
    monkeypatch.setattr(port, "loss", lambda b, **k: sizes.append(len(b["bboxs"])) or loss(b, **k))
    got = PortTester({}, port, DataLoader(ds)).run_consistency(process_num=3)["consistency"]
    assert sizes == [2] * 8
    ov, (ph, pw), errs = ds.overlap, ds.patch_raw_shape, []
    for batch in DataLoader(ds):
        preds = []
        for i in range(16):
            sub = {"image_lr": batch["image_lr"][:1],
                   **{k: batch[k][:, i] for k in ("crops_image_hr", "crop_depths", "bboxs")}}
            with torch.inference_mode():
                depth = port.loss(sub)[1]["depth_pred"]
                preds.append(resize(depth, (ph, pw), "bilinear", True)[0, :, :, 0].numpy())
        frame = []
        for ii in range(4):
            for jj in range(4):
                k = ii * 4 + jj
                if ii > 0:
                    frame.append(np.abs(preds[k - 4][-ov:, :] - preds[k][:ov, :]).ravel())
                if jj > 0:
                    frame.append(np.abs(preds[k - 1][:, -ov:] - preds[k][:, :ov]).ravel())
        errs.append(float(np.concatenate(frame).mean()))
    assert np.isclose(got, errs[0], rtol=1e-4, atol=1e-5), (got, errs)


def test_consistency_resize_is_jax_align_corners():
    """The crops' depths go to ``patch_raw_shape`` as JAX's
    ``resize(..., "bilinear", True)`` takes them."""
    x = np.random.RandomState(3).rand(4, 48, 64, 1).astype(np.float32) * 20
    got = resize(torch.from_numpy(x), (24, 32), "bilinear", True).numpy()
    want = np.asarray(jresize(jnp.asarray(x), (24, 32), "bilinear", True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_evaluate_consistency_matches_jax(capsys):
    results = [{"consistency_error": 0.5}, {"consistency_error": float("nan")},
               {"consistency_error": 0.125}]
    want = JDepthDataset.evaluate_consistency(None, results)
    got = DepthDataset().evaluate_consistency(results)
    assert got == want == {"consistency_error": 0.3125}
    assert "Consistency Summary:\nconsistency_error\n0.312500" in capsys.readouterr().out


def test_run_consistency_rejects_plain_dataset(models, tmp_path):
    """A dataset without the crop grid raises a ``ValueError`` in both."""
    jm, variables, port = models("flagship")
    jl, pl = loaders(mode="infer", length=1, image_raw_shape=(96, 128), network_process_size=(48, 64))
    with pytest.raises(ValueError, match="consistency-mode dataset"):
        JTester({}, jm, jl, work_dir=str(tmp_path)).run_consistency(variables, process_num=4)
    with pytest.raises(ValueError, match="consistency-mode dataset"):
        PortTester({}, port, pl).run_consistency(process_num=4)


def benchmark_lines(text: str) -> list:
    """Each line's key and value, a number's digits replaced by ``9``."""
    return [tuple(line.split(": ")) for line in re.sub(r"\d", "9", text).splitlines()]


def test_benchmark_txt_has_jax_format(models, tmp_path, monkeypatch):
    """``benchmark.txt``: JAX's lines (``cai_mode``, ``process_num``,
    ``fps_mean``, ``fps_variance``, six decimals), written by JAX's
    ``benchmark`` over a stub model; the port times its tiny flagship. Every
    frame takes a new generator seeded 0 (JAX reuses ``PRNGKey(0)``)."""
    _, _, port = models("flagship")
    stub = SimpleNamespace(infer=lambda *a, **k: (jnp.zeros(1), None))
    loader = SimpleNamespace(dataset=None)
    JTester({}, stub, loader, work_dir=str(tmp_path / "jax")).benchmark(
        {}, None, None, cai_mode="m1", process_num=4, iters=2, warmup=1, repeats=2)
    seeds, infer = [], port.infer
    monkeypatch.setattr(port, "infer", lambda *a, generator, **k: seeds.append(
        (id(generator), generator.initial_seed())) or infer(*a, generator=generator, **k))
    rng = np.random.RandomState(0)
    lr, hr = rng.rand(1, 48, 64, 3).astype(np.float32), rng.rand(1, 96, 128, 3).astype(np.float32)
    out = PortTester({}, port, loader, work_dir=str(tmp_path / "port")).benchmark(
        lr, hr, cai_mode="m1", process_num=4, iters=2, warmup=1, repeats=2)
    assert sorted(out) == ["fps", "fps_variance"] and out["fps"] > 0 and out["fps_variance"] >= 0
    assert len(seeds) == 6 and {s[1] for s in seeds} == {0}
    want = (tmp_path / "jax" / "benchmark.txt").read_text()
    got = (tmp_path / "port" / "benchmark.txt").read_text()
    assert benchmark_lines(got)[:2] == benchmark_lines(want)[:2] == [("cai_mode", "m9"),
                                                                    ("process_num", "9")]
    assert [(k, v.split(".")[1]) for k, v in benchmark_lines(got)[2:]] == \
        [(k, v.split(".")[1]) for k, v in benchmark_lines(want)[2:]] == \
        [("fps_mean", "999999"), ("fps_variance", "999999")]
    assert float(got.splitlines()[2].split(": ")[1]) == round(out["fps"], 6)


class _Frames:
    """Infer frames, the second without ground truth."""

    def __init__(self):
        self.frames = SyntheticDataset(mode="infer", length=2, image_raw_shape=(96, 128),
                                       network_process_size=(48, 64))

    def __len__(self):
        return 2

    def __getitem__(self, i):
        out = self.frames[i]
        if i == 1:
            del out["depth_gt"]
        return out


def test_show_gts_matches_jax(tmp_path):
    """One colored ground truth ``{name}_gt.png`` an image that has one,
    pixel for pixel JAX's (the Tester's colormap, the whole range)."""
    from PIL import Image

    ds = _Frames()
    jdir = JTester({}, None, JDataLoader(ds, batch_size=1, num_prefetch=0),
                   work_dir=str(tmp_path)).show_gts(out_dir=str(tmp_path / "jax"))
    pdir = PortTester({}, None, DataLoader(ds), work_dir=str(tmp_path)).show_gts(
        out_dir=str(tmp_path / "port"))
    assert os.listdir(pdir) == os.listdir(jdir) == ["synthetic_0000_gt.png"]
    got, want = (np.asarray(Image.open(os.path.join(d, "synthetic_0000_gt.png"))) for d in (pdir, jdir))
    np.testing.assert_array_equal(got, want)
    assert PortTester({}, None, DataLoader(ds), work_dir=str(tmp_path / "w")).show_gts() == \
        str(tmp_path / "w" / "gts")
