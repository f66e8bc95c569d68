"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is a standalone source with a plain C interface
(it may include local headers, ``csrc/*.cuh``). It is compiled at first
use with ``nvcc`` for ``sm_90a`` into a shared library under
``patchrefinerv2_torch/_build/`` (named by a hash of the source and of
every local header it includes, so an edited source or header rebuilds)
and loaded with ``ctypes``. Every
C entry takes ``void*`` pointers and a ``void*`` CUDA stream and returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.

Nothing here runs at import time: this module only imports ``ctypes``
and the standard library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("roi_align", "resize", "blend", "attention", "gated_conv", "canny", "tail_conv",
           "quant_conv", "bins", "hysteresis")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes (``#include
    "..."``, followed through the headers), in the order first met."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [f.parent / m.decode() for m in _LOCAL_INCLUDE.findall(f.read_bytes())]
    return files


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in local_files(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together. Returns the paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {n: _target(n) for n in names}
    procs = {}
    for n, out in outs.items():
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                _nvcc_cmd(n, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
    errors = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc={p.returncode}):\n{log}")
        else:
            os.replace(tmp, outs[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        path = build((name,))[name]
        return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0, n_double: int = 0):
    """Declare a C entry of the form ``int f(void* x n_ptr, long long x n_int,
    float x n_float, double x n_double, int dtype, void* stream)`` and return
    it."""
    fn = getattr(library(name), symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr
        + [ctypes.c_longlong] * n_int
        + [ctypes.c_float] * n_float
        + [ctypes.c_double] * n_double
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


@functools.lru_cache(maxsize=None)
def sms(device) -> int:
    """The number of SMs of a CUDA device (the launch plans size their grids
    by it)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(*tensors) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"expected a contiguous tensor, got strides {t.stride()} for shape {tuple(t.shape)}")


def on_cpu(t) -> bool:
    """True for a CPU tensor (plain path); raise for any device that is
    neither CPU nor CUDA."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"
