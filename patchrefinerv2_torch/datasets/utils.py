"""File readers of the datasets: an image file as an array (PIL) and the
Middlebury PFM reader, the port of ``patchrefinerv2_tpu/datasets/utils.py``
(``read_pfm`` :10-30)."""

from __future__ import annotations

import re

import numpy as np


def read_image(path: str, dtype=None, mode: str | None = None) -> np.ndarray:
    """An image file as an array (PIL: 16-bit PNGs as uint16), converted to
    ``mode`` first when given."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert(mode) if mode else im, dtype)


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """A PFM file: ``PF`` (H, W, 3) colour or ``Pf`` (H, W) gray float32,
    little-endian when the scale line is negative, else big-endian, stored
    bottom row first (returned top row first); returns (data, |scale|)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape)), abs(scale)
