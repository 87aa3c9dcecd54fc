"""Datasets and the loader; `create_dataset` is the factory the train CLI
uses (`gimmvfi_tpu/data/__init__.py`)."""

from .flow_dataset import VimeoFlowTriplets
from .loader import DataLoader


def create_dataset(name: str, path: str, crop_size=None):
    """(train, test) datasets by name (`src/datasets/__init__.py:20-48`):
    `fast_vimeo_flow`, the stage-1 flow triplets. `vimeo_arb`, stage 2's
    frames, comes with stage-2 training (ROADMAP A13b)."""
    if name == "vimeo_arb":
        raise NotImplementedError("vimeo_arb (stage-2 training) is not ported yet: ROADMAP A13b")
    if name == "fast_vimeo_flow":
        args = {"crop": int(crop_size[0])} if crop_size else {}
        return (VimeoFlowTriplets(path, split="train", **args),
                VimeoFlowTriplets(path, split="test", **args))
    raise ValueError(f"unknown dataset: {name}")


__all__ = ["DataLoader", "VimeoFlowTriplets", "create_dataset"]
