"""The host library of the data path, ``csrc/dataio.cpp``, bound with
ctypes: the raw BGR blob load and the bilinear align-corners resize of the
readers (the port of ``patchrefinerv2_tpu/datasets/native.py``).

It is compiled at first use with ``g++`` into ``patchrefinerv2_torch/_build/``
(named by a hash of the source and the flags, written under a temporary
name and renamed, so that processes building at once do not see half a
file) and loaded once a process. There is no fallback: when it cannot be
built the call raises, since a numpy stand-in would round ``image_lr`` and
the evaluation image differently. The foreign calls release the GIL, so the
loader's threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from patchrefinerv2_torch.ops._cuda import BUILD_DIR, CSRC

SOURCE = CSRC / "dataio.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-shared")

_lock = threading.Lock()
_float_p = ctypes.POINTER(ctypes.c_float)


def target():
    """The library's path under ``_build/`` for this source and these flags."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libdataio-{h.hexdigest()[:12]}.so"


def build():
    """Compile the library unless it is there; returns its path."""
    out = target()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the data path's host library (csrc/dataio.cpp) "
                           "builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    p = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (rc={p.returncode}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    with _lock:
        lib = ctypes.CDLL(str(build()))
    lib.load_raw_bgr_as_rgb_f32.argtypes = [ctypes.c_char_p, _float_p, ctypes.c_int, ctypes.c_int]
    lib.load_raw_bgr_as_rgb_f32.restype = ctypes.c_int
    lib.resize_bilinear_ac.argtypes = [_float_p] + [ctypes.c_int] * 3 + [_float_p] + [ctypes.c_int] * 2
    lib.resize_bilinear_ac.restype = None
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_float_p)


def load_raw_bgr_as_rgb_f32(path: str, h: int = 2160, w: int = 3840) -> np.ndarray:
    """An (h, w, 3) uint8 BGR blob on disk as float32 RGB, each value times
    1/255.f; raises ``OSError`` when the file is missing or short."""
    out = np.empty((h, w, 3), np.float32)
    if library().load_raw_bgr_as_rgb_f32(os.fsencode(path), _fp(out), h, w) != 0:
        raise OSError(f"cannot read {h}x{w}x3 bytes from {path}")
    return out


def _hwc(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) image, got shape {img.shape}")
    return np.ascontiguousarray(img, np.float32)


def resize_bilinear_ac(img: np.ndarray, size) -> np.ndarray:
    """``img`` (H, W, C) resized to ``size`` (bilinear, align_corners on), float32."""
    img = _hwc(img)
    ih, iw, c = img.shape
    oh, ow = size
    out = np.empty((oh, ow, c), np.float32)
    library().resize_bilinear_ac(_fp(img), ih, iw, c, _fp(out), oh, ow)
    return out

