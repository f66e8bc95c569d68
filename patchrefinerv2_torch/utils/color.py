"""Depth colorization for image panels, the port of
``patchrefinerv2_tpu/utils/color.py`` (``colorize``, the reference's
``color.py:95-158``): a matplotlib colormap over percentile-normalised
values. matplotlib is imported only when a panel is drawn."""

from __future__ import annotations

import numpy as np


def colorize(value, vmin=None, vmax=None, cmap="magma_r", invalid_val=-99, invalid_mask=None,
             background_color=(128, 128, 128, 255), gamma_corrected=False, value_transform=None,
             vminp=2, vmaxp=95) -> np.ndarray:
    """(H, W, 4) uint8 colors of ``value``, normalised between its
    ``vminp`` and ``vmaxp`` percentiles over the valid pixels unless
    ``vmin``/``vmax`` are given; invalid pixels get ``background_color``."""
    import matplotlib

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
    img = matplotlib.colormaps[cmap](value, bytes=True)
    img[invalid_mask] = background_color
    if gamma_corrected:
        img = (np.power(img / 255.0, 2.2) * 255).astype(np.uint8)
    return img
