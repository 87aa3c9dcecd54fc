"""`prepare`: device ms of the kernels launched inside the program's
`prepare` span, a pair (mean over the traced calls)."""

from ._common import stage_device_s


def read(ctx):
    s = stage_device_s(ctx.view, "prepare")
    return 1e3 * sum(s) / len(s) if s else None
