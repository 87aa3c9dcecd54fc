"""`decode_one`: device ms of the kernels launched inside the program's
`decode_one` spans, a timestep (mean over the traced spans)."""

from ._common import stage_device_s


def read(ctx):
    s = stage_device_s(ctx.view, "decode_one")
    return 1e3 * sum(s) / len(s) if s else None
