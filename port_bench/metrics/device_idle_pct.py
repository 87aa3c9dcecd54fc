"""The device: the share of the traced stretch with neither a kernel nor a
copy running on the card."""


def read(ctx):
    w = ctx.view.window_s()
    return 100.0 * (1.0 - ctx.view.busy_s() / w) if w > 0 else None
