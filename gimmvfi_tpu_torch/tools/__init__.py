"""The port's counterparts of the JAX probes in `tools/`, run on the card
with `python -m gimmvfi_tpu_torch.tools.<name>`."""
