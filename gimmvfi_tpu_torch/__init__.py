"""PyTorch/CUDA port of gimmvfi_tpu (GIMM-VFI-R inference).

The JAX package `gimmvfi_tpu` is the reference this package is held
against. Module paths mirror it (`ops/`, `nn/`, `flow/`, `models/`,
`utils/`). Internals are NCHW; `ops.softsplat.softsplat` and the model
entry points keep the reference's channels-last layout.
"""
