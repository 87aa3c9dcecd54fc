"""The whole pipeline: the FLOPs of one call, counted over the reference at
the cell's shapes (`flops.py`), times the traced calls, over the traced
stretch's seconds, as a share of the H100's dense bf16 peak."""

from ..peaks import BF16_FLOPS


def read(ctx):
    w = ctx.view.window_s()
    if not ctx.flops_per_call or w <= 0:
        return None
    return 100.0 * ctx.flops_per_call * ctx.calls / w / BF16_FLOPS
