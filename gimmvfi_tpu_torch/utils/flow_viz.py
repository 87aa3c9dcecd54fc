"""Optical-flow visualization, the Middlebury color wheel
(`gimmvfi_tpu/utils/flow_viz.py`), numpy.

Hue encodes direction from a 55-bin RY/YG/GC/CB/BM/MR wheel, saturation
encodes magnitude normalized by the image's largest radius.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    transitions = [("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13), ("MR", 6)]
    total = sum(n for _, n in transitions)
    wheel = np.zeros((total, 3), np.float32)
    col = 0
    for name, n in transitions:
        ramp = np.arange(n, dtype=np.float32) / n
        if name == "RY":
            wheel[col : col + n, 0] = 255
            wheel[col : col + n, 1] = 255 * ramp
        elif name == "YG":
            wheel[col : col + n, 0] = 255 * (1 - ramp)
            wheel[col : col + n, 1] = 255
        elif name == "GC":
            wheel[col : col + n, 1] = 255
            wheel[col : col + n, 2] = 255 * ramp
        elif name == "CB":
            wheel[col : col + n, 1] = 255 * (1 - ramp)
            wheel[col : col + n, 2] = 255
        elif name == "BM":
            wheel[col : col + n, 2] = 255
            wheel[col : col + n, 0] = 255 * ramp
        elif name == "MR":
            wheel[col : col + n, 2] = 255 * (1 - ramp)
            wheel[col : col + n, 0] = 255
        col += n
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization."""
    u = np.asarray(flow[..., 0], np.float32)
    v = np.asarray(flow[..., 1], np.float32)
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u * u + v * v)

    ncols = _WHEEL.shape[0]
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]

    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    mask = rad[..., None] <= 1
    col = np.where(mask, 1 - rad[..., None] * (1 - col), col * 0.75)

    img = np.floor(255 * col).astype(np.uint8)
    if convert_to_bgr:
        img = img[..., ::-1]
    return img
