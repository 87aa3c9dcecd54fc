"""Batched, shuffled, host-sharded data loading (`gimmvfi_tpu/data/loader.py`).

The reference's torch DataLoader + DistributedSampler
(`trainers/trainer.py:49-78`) as a thread-pool loader producing stacked
numpy batches, incomplete last batch dropped. As the JAX loader, host
`shard_id` of `num_shards` loads `order[shard_id::num_shards]` of the
epoch's order in host batches of `batch_size`. Under data parallelism
(`parallel/dist.py`) a host batch spans the host's `local_world` ranks, and
local rank `l` loads only its contiguous rows `[l B, (l + 1) B)`, B =
`batch_size // local_world`: the rows JAX's `shard_batch` gives device `l`.
Item i of an epoch draws from `np.random.default_rng((seed, epoch, i))`,
whichever process loads it, so the batches are the JAX package's, byte for
byte.
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
    """Epoch-based loader: shuffle -> shard -> parallel map -> stack.

    `dataset[index, rng]` must return a dict of numpy arrays. Deterministic
    given (seed, epoch) — the reference's DistributedSampler.set_epoch
    equivalent (`trainer.py:96`). `batch_size` is the host batch; each
    batch yielded holds this rank's `batch_size // local_world` rows of it.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1, local_rank: int = 0,
                 local_world: int = 1):
        if batch_size % local_world or not 0 <= local_rank < local_world:
            raise ValueError(f"host batch {batch_size} over {local_world} local ranks "
                             f"(local rank {local_rank})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.rows = slice(local_rank * batch_size // local_world,
                          (local_rank + 1) * batch_size // local_world)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return (len(self.dataset) // self.num_shards) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        root = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            order = root.permutation(n)
        order = order[self.shard_id :: self.num_shards]

        with cf.ThreadPoolExecutor(NUM_WORKERS) as pool:
            for b in range(len(self)):
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size][self.rows]
                rngs = [
                    np.random.default_rng((self.seed, self.epoch, int(i)))
                    for i in idxs
                ]
                samples = list(
                    pool.map(lambda a: self.dataset[a], zip(map(int, idxs), rngs))
                )
                yield _stack(samples)
