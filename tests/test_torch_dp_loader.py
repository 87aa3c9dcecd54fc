"""The port's host-sharded loader against the JAX package's, on the CPU.

Host `h` of `H` loads `order[h::H]` in host batches, as JAX's
`DataLoader(shard_id, num_shards)`; local rank `l` of a host's
`local_world` ranks loads only rows `[l B, (l + 1) B)` of each host batch,
the rows JAX's `shard_batch` gives device `l`. So the local ranks' batches
stacked in order are JAX's host batch, array for array, in every epoch,
with and without shuffling.
"""

import numpy as np
import pytest
import torch

from gimmvfi_tpu.data.loader import DataLoader as JaxDataLoader
from gimmvfi_tpu_torch.data import DataLoader

torch.set_num_threads(1)
B = 2  # a rank's rows


class _ToyData:
    """23 items, each drawing from the rng its loader seeds it with; records
    the indices it was asked for."""

    def __init__(self):
        self.meta_data = list(range(23))
        self.loaded = []

    def __len__(self):
        return len(self.meta_data)

    def __getitem__(self, args):
        i, rng = args
        self.loaded.append(i)
        return {"x": np.full((3,), self.meta_data[i], np.float32) + rng.random(3, np.float32),
                "k": rng.integers(0, 100, (2,)), "i": np.int64(i)}


@pytest.mark.parametrize("local_world", [1, 2])
@pytest.mark.parametrize("hosts", [1, 2, 3])
@pytest.mark.parametrize("shuffle,epoch", [(True, 0), (True, 3), (False, 1)])
def test_rank_rows_stack_to_the_jax_host_batch(shuffle, epoch, hosts, local_world):
    host_batch = B * local_world
    for host in range(hosts):
        ref = JaxDataLoader(_ToyData(), host_batch, shuffle=shuffle, seed=7, shard_id=host,
                            num_shards=hosts)
        ranks = [DataLoader(_ToyData(), host_batch, shuffle=shuffle, seed=7, shard_id=host,
                            num_shards=hosts, local_rank=lr, local_world=local_world)
                 for lr in range(local_world)]
        for loader in (ref, *ranks):
            loader.set_epoch(epoch)
        assert all(len(r) == len(ref) for r in ranks) and len(ref) > 0
        got = [list(r) for r in ranks]
        want = list(ref)
        assert all(len(g) == len(want) for g in got)
        for step, host_b in enumerate(want):
            for k in host_b:
                stacked = np.concatenate([g[step][k] for g in got])
                assert stacked.dtype == host_b[k].dtype and np.array_equal(stacked, host_b[k]), k
            for lr, g in enumerate(got):
                assert g[step]["x"].shape[0] == B


def test_a_rank_loads_only_its_rows():
    """Each local rank's dataset is asked for its rows' items alone; the
    ranks' items are disjoint and together the host's (2 hosts, 2 local
    ranks, host batch 4)."""
    hosts, local_world = 2, 2
    for host in range(hosts):
        sets = []
        for lr in range(local_world):
            ds = _ToyData()
            loader = DataLoader(ds, B * local_world, seed=1, shard_id=host, num_shards=hosts,
                                local_rank=lr, local_world=local_world)
            loader.set_epoch(2)
            batches = list(loader)
            assert sorted(ds.loaded) == sorted(int(i) for b in batches for i in b["i"])
            sets.append(set(ds.loaded))
        order = np.random.default_rng((1, 2)).permutation(23)[host::hosts]
        host_items = order[: len(loader) * B * local_world]
        assert not sets[0] & sets[1] and sets[0] | sets[1] == set(map(int, host_items))


def test_len_and_bad_rows():
    """`__len__` is JAX's `(n // num_shards) // batch`; a host batch that
    the local ranks cannot split evenly, or a local rank out of range,
    raises."""
    for shards, batch in ((1, 4), (2, 4), (3, 2), (5, 6)):
        assert len(DataLoader(_ToyData(), batch, num_shards=shards)) == (23 // shards) // batch
        assert len(DataLoader(_ToyData(), batch, num_shards=shards)) == len(
            JaxDataLoader(_ToyData(), batch, num_shards=shards))
    with pytest.raises(ValueError, match="local ranks"):
        DataLoader(_ToyData(), 3, local_world=2)
    with pytest.raises(ValueError, match="local rank 2"):
        DataLoader(_ToyData(), 4, local_rank=2, local_world=2)
