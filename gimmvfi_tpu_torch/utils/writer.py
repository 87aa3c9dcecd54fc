"""TensorBoard scalar writers (`gimmvfi_tpu/utils/writer.py`).

`Writer` keeps the reference's three event directories (train / valid /
valid_ema) under the run directory; tensorboardX is imported when one is
made, and `ImportError` reaches the caller where it is not installed.
`NullWriter` writes nothing. Scalars only: the image grids come with
stage-2 training.
"""

from __future__ import annotations

import os
from typing import Mapping


class Writer:
    """Three-way TensorBoard writer ('train' | 'valid' | 'valid_ema')."""

    def __init__(self, result_path: str):
        from tensorboardX import SummaryWriter

        self.writers = {mode: SummaryWriter(os.path.join(result_path, mode))
                        for mode in ("train", "valid", "valid_ema")}

    def add_scalar(self, tag: str, value: float, mode: str, step: int):
        self.writers[mode].add_scalar(tag, float(value), step)

    def add_scalars(self, values: Mapping[str, float], mode: str, step: int):
        for tag, value in values.items():
            self.add_scalar(tag, value, mode, step)

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

    def close(self):
        pass
