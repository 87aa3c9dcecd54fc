"""TensorBoard writers and the training image grids (`gimmvfi_tpu/utils/writer.py`).

`Writer` keeps the reference's three event directories (train / valid /
valid_ema) under the run directory; tensorboardX is imported when one is
made, and `ImportError` reaches the caller where it is not installed.
`NullWriter` writes nothing. `add_image` also writes each grid as a PPM
under `<run dir>/grids/`, which needs no image library.

The grids are the trainers' per-epoch visualizations
(`trainer_gimmvfi.py:361-421`, `trainer_gimm.py:201-286`): rows of
[I0 | pred | GT | I1 | flow viz ...], channels-last numpy in [0, 1].
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np

from ..data.frame_io import write_ppm
from .flow_viz import flow_to_image


class Writer:
    """Three-way TensorBoard writer ('train' | 'valid' | 'valid_ema')."""

    def __init__(self, result_path: str):
        from tensorboardX import SummaryWriter

        self.result_path = result_path
        self.writers = {mode: SummaryWriter(os.path.join(result_path, mode))
                        for mode in ("train", "valid", "valid_ema")}

    def add_scalar(self, tag: str, value: float, mode: str, step: int):
        self.writers[mode].add_scalar(tag, float(value), step)

    def add_scalars(self, values: Mapping[str, float], mode: str, step: int):
        for tag, value in values.items():
            self.add_scalar(tag, value, mode, step)

    def add_image(self, tag: str, img_hwc: np.ndarray, mode: str, step: int):
        """img_hwc: (H, W, 3) float in [0, 1] or uint8."""
        img = np.asarray(img_hwc)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        self.writers[mode].add_image(tag, img, step, dataformats="HWC")
        grid_dir = os.path.join(self.result_path, "grids")
        os.makedirs(grid_dir, exist_ok=True)
        write_ppm(os.path.join(grid_dir, f"{mode}_{tag.replace('/', '_')}_{step}.ppm"), img)

    def close(self):
        for w in self.writers.values():
            w.close()


class NullWriter:
    """A writer that writes nothing (no tensorboardX, or not the logging
    process)."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_scalars(self, *args, **kwargs):
        pass

    def add_image(self, *args, **kwargs):
        pass

    def close(self):
        pass


def reconstruction_grid(img0: np.ndarray, pred: np.ndarray, gt: np.ndarray, img1: np.ndarray,
                        flow_t0: Optional[np.ndarray] = None,
                        flow_t1: Optional[np.ndarray] = None,
                        max_rows: int = 4) -> np.ndarray:
    """One row a sample: [I0 | pred | GT | I1 (| flow viz ...)]; images
    (N, H, W, 3) in [0, 1], flows (N, H, W, 2) in pixels."""
    rows = []
    for i in range(min(max_rows, img0.shape[0])):
        cells = [img0[i], pred[i], gt[i], img1[i]]
        for flow in (flow_t0, flow_t1):
            if flow is not None:
                cells.append(flow_to_image(np.asarray(flow[i])) / 255.0)
        rows.append(np.concatenate([np.asarray(c, np.float32) for c in cells], axis=1))
    return np.concatenate(rows, axis=0)


def flow_grid(pred_nflow: np.ndarray, target_nflow: np.ndarray, max_rows: int = 4) -> np.ndarray:
    """Stage-1 grid: [pred flow viz | target flow viz] a sample, from
    normalized flows in [0, 1]."""
    rows = []
    for i in range(min(max_rows, pred_nflow.shape[0])):
        p = flow_to_image(np.asarray(pred_nflow[i] * 2.0 - 1.0)) / 255.0
        t = flow_to_image(np.asarray(target_nflow[i] * 2.0 - 1.0)) / 255.0
        rows.append(np.concatenate([p, t], axis=1))
    return np.concatenate(rows, axis=0)
