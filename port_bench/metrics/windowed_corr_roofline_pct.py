"""The windowed correlation lookup (`ops/corr.py: windowed_corr_lookup` →
`csrc/windowed_corr_tf32.cu` for float32, `csrc/windowed_corr_mma.cu` for
bf16): its bound (`work/windowed_corr.py`) over the device time of its
kernels, found by name."""

from ._common import kernel_roofline_pct

NAMES = ("windowed_corr_tf32_kernel", "windowed_corr_mma_kernel")


def read(ctx):
    groups = [[a] for a in ctx.view.device if any(n in a.name for n in NAMES)]
    return kernel_roofline_pct(ctx, "windowed_corr", groups)
