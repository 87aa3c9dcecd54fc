"""Metric accumulation and PSNR (`gimmvfi_tpu/utils/metrics.py`), numpy.

`MetricAccumulator` keeps running sums of scalar metrics with a printable
summary line.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np


class MetricAccumulator:
    def __init__(self, names: Iterable[str]):
        self.names = list(names)
        self.reset()

    def reset(self):
        self.sums = {n: 0.0 for n in self.names}
        self.count = 0

    def update(self, metrics: Mapping[str, float], count: int = 1):
        for n in self.names:
            if n in metrics:
                self.sums[n] += float(metrics[n]) * count
        self.count += count

    def summary(self) -> dict[str, float]:
        c = max(self.count, 1)
        return {n: self.sums[n] / c for n in self.names}

    def print_line(self) -> str:
        return ", ".join(f"{n}: {v:.4f}" for n, v in self.summary().items())


def compute_psnr_np(pred: np.ndarray, target: np.ndarray) -> float:
    mse = float(((pred - target) ** 2).mean())
    return -10.0 * np.log10(max(mse, 1e-12))
