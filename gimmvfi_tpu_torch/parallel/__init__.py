"""Parallelism across cards (`gimmvfi_tpu/parallel/`): `dist.py` starts the
group and holds the collectives (data-parallel training under `torchrun`);
`spatial.py` splits one pair's work by width over the ranks.

`spatial` is imported at first use of `interpolate_spatial_sharded`: it
reads the layers' conv reach (`nn/layers.py`), which imports `dist`."""

__all__ = ["interpolate_spatial_sharded"]


def __getattr__(name):
    if name == "interpolate_spatial_sharded":
        from .spatial import interpolate_spatial_sharded

        return interpolate_spatial_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
