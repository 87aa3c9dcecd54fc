"""Parallelism across cards (`gimmvfi_tpu/parallel/`): `dist.py` starts the
group and holds the collectives (data-parallel training under `torchrun`);
`spatial.py` splits one pair's per-timestep decode by width over the ranks."""

from .spatial import interpolate_spatial_sharded

__all__ = ["interpolate_spatial_sharded"]
