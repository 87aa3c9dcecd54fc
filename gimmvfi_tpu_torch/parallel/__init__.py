"""Data-parallel training, one process a card under `torchrun`
(`gimmvfi_tpu/parallel/`): `dist.py` starts the group and holds the
collectives."""
