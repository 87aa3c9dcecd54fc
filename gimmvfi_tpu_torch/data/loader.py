"""Batched, shuffled data loading (`gimmvfi_tpu/data/loader.py`).

The reference's torch DataLoader (`trainers/trainer.py:49-78`) as a
thread-pool loader producing stacked numpy batches, incomplete last batch
dropped, for one process (data parallelism is later work). Item i of an
epoch draws from `np.random.default_rng((seed, epoch, i))`, so the batches
are the JAX package's, byte for byte.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Iterator

import numpy as np


def _stack(samples: list[dict[str, Any]]) -> dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples], axis=0)
    return out


NUM_WORKERS = 8  # the loader's threads


class DataLoader:
    """Epoch-based loader: shuffle -> parallel map -> stack.

    `dataset[index, rng]` must return a dict of numpy arrays. Deterministic
    given (seed, epoch) — the reference's DistributedSampler.set_epoch
    equivalent (`trainer.py:96`).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        root = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            order = root.permutation(n)

        with cf.ThreadPoolExecutor(NUM_WORKERS) as pool:
            for b in range(len(self)):
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                rngs = [
                    np.random.default_rng((self.seed, self.epoch, int(i)))
                    for i in idxs
                ]
                samples = list(
                    pool.map(lambda a: self.dataset[a], zip(map(int, idxs), rngs))
                )
                yield _stack(samples)
