"""Datasets and the loader; `create_dataset` is the factory the train CLI
uses (`gimmvfi_tpu/data/__init__.py`)."""

from .flow_dataset import VimeoFlowTriplets
from .loader import DataLoader
from .vimeo_arb import VimeoArbitrary


def create_dataset(name: str, path: str, crop_size=None, aug: bool = True):
    """(train, test) datasets by name (`src/datasets/__init__.py:20-48`):
    `fast_vimeo_flow`, stage 1's flow triplets, and `vimeo_arb`, stage 2's
    septuplet frames (`aug` its train augmentation)."""
    if name == "vimeo_arb":
        args = {"aug": aug}
        if crop_size:
            args["crop_size"] = tuple(crop_size)
        return (VimeoArbitrary(path, split="train", **args),
                VimeoArbitrary(path, split="test", **args))
    if name == "fast_vimeo_flow":
        args = {"crop": int(crop_size[0])} if crop_size else {}
        return (VimeoFlowTriplets(path, split="train", **args),
                VimeoFlowTriplets(path, split="test", **args))
    raise ValueError(f"unknown dataset: {name}")


__all__ = ["DataLoader", "VimeoArbitrary", "VimeoFlowTriplets", "create_dataset"]
