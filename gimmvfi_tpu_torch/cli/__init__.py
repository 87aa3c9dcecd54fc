"""The port's user entry points: `python -m gimmvfi_tpu_torch.cli.video_nx` and
`python -m gimmvfi_tpu_torch.cli.benchmarks`."""
