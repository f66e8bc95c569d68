"""The port stands alone: it imports no JAX, no Flax and nothing of the JAX
package, uses no library attention, compiler or finished-kernel package,
and its entry points need a card unless the caller asks for the CPU.
``chip_smoke.py`` may time PyTorch's fused attention as the attention
kernel's yardstick (``library_ms``), and nothing else of that list."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from tests.test_torch_slice import slice_config

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "patchrefinerv2_torch"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "patchrefinerv2_tpu")
FORBIDDEN_CALLS = ("scaled_dot_product_attention", "torch.compile", "flash_attn", "xformers")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import patchrefinerv2_torch
for m in pkgutil.walk_packages(patchrefinerv2_torch.__path__, "patchrefinerv2_torch."):
    importlib.import_module(m.name)
import chip_smoke
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN_MODULES]
    assert not bad, bad
    assert "patchrefinerv2_torch.models.patchrefinerplus" in loaded


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_and_calls(path):
    """No import of JAX or the JAX package anywhere in the file, not even
    inside a function, and no library attention or compiler."""
    text = path.read_text()
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        assert not [n for n in names if n.split(".")[0] in FORBIDDEN_MODULES], (path, names)
    allowed = ("scaled_dot_product_attention",) if path.name == "chip_smoke.py" else ()
    assert not [c for c in FORBIDDEN_CALLS if c in text and c not in allowed], path


def test_entry_point_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PatchRefinerPlus(slice_config())


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any device other than the CPU or a card raises in every
    wrapper instead of running the plain version."""
    from patchrefinerv2_torch.ops import (
        TileBlender, attention, attractor_update, crop_resize, gate_tail, layer_norm,
        log_binomial_depth, resize, roi_align,
    )

    m = torch.empty((1, 4, 4, 2), device="meta")
    q = torch.empty((1, 2, 5, 16), device="meta")
    calls = [
        lambda: roi_align(m, torch.zeros(1, 4, device="meta"), torch.zeros(1, device="meta"),
                          (4, 4)),
        lambda: resize(m, (8, 8)),
        lambda: crop_resize(m[0], torch.zeros(1, 2, device="meta"), (2, 2), (4, 4)),
        lambda: layer_norm(m, m[0, 0, 0], m[0, 0, 0]),
        lambda: TileBlender.add_pass(TileBlender.init((8, 8), "meta"), m[..., 0], m[0, :, :, 0],
                                     torch.zeros(1, 2, device="meta")),
        lambda: TileBlender.finalize(TileBlender.init((8, 8), "meta")),
        lambda: attention(q, q, q, 0.25),
        lambda: gate_tail(m, m, torch.empty((2, 2), device="meta"), m[0, 0, 0], m[0, 0, 0]),
        lambda: attractor_update(m, m),
        lambda: log_binomial_depth(torch.empty((3, 4), device="meta"),
                                   torch.empty((3, 8), device="meta"), 8, 0.1, 50.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
