"""Depth colorization and the depth image files, the port of
``patchrefinerv2_tpu/utils/color.py`` (``colorize``, the reference's
``color.py:95-158``; ``save_raw_16bit`` and ``save_colored`` :55-72): a
colormap (``utils/colormaps.py``'s tables of matplotlib's) over
percentile-normalised values, and PNGs written by cv2, which is imported
only when a file is written."""

from __future__ import annotations

import numpy as np

from patchrefinerv2_torch.utils import colormaps


def colorize(value, vmin=None, vmax=None, cmap="magma_r", invalid_val=-99, invalid_mask=None,
             background_color=(128, 128, 128, 255), gamma_corrected=False, value_transform=None,
             vminp=2, vmaxp=95) -> np.ndarray:
    """(H, W, 4) uint8 colors of ``value``, normalised between its
    ``vminp`` and ``vmaxp`` percentiles over the valid pixels unless
    ``vmin``/``vmax`` are given; invalid pixels get ``background_color``."""
    value = np.asarray(value, np.float32).squeeze()
    if invalid_mask is None:
        invalid_mask = value == invalid_val
    mask = np.logical_not(invalid_mask)
    vmin = np.percentile(value[mask], vminp) if vmin is None else vmin
    vmax = np.percentile(value[mask], vmaxp) if vmax is None else vmax
    value = (value - vmin) / (vmax - vmin) if vmin != vmax else value * 0.0
    value[invalid_mask] = np.nan
    if value_transform:
        value = value_transform(value)
    img = colormaps.apply(cmap, value)
    img[invalid_mask] = background_color
    if gamma_corrected:
        img = (np.power(img / 255.0, 2.2) * 255).astype(np.uint8)
    return img


def save_raw_16bit(depth, path: str) -> None:
    """``depth`` times 256 (float64, truncated to uint16) as a 16-bit PNG, the
    offline pseudo labels' format."""
    import cv2

    cv2.imwrite(path, (np.asarray(depth, np.float64).squeeze() * 256.0).astype(np.uint16))


def save_colored(depth, path: str, cmap: str, vminp: float, vmaxp: float) -> None:
    """``colorize`` of ``depth`` between its ``vminp`` and ``vmaxp``
    percentiles as an 8-bit RGB PNG."""
    import cv2

    img = colorize(depth, cmap=cmap, vminp=vminp, vmaxp=vmaxp)
    cv2.imwrite(path, cv2.cvtColor(img[..., :3], cv2.COLOR_RGB2BGR))
