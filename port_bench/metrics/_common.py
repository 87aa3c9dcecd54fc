"""Helpers the per-layer readers share."""

from __future__ import annotations

import sys


def stage_device_s(view, name: str) -> list[float]:
    """Device seconds of the activities launched inside each span `name`."""
    return [sum(a.dur for a in acts) for acts in view.launched_in(name)]


def kernel_roofline_pct(ctx, kernel: str, groups: list[list]):
    """100 x (the bound of `kernel`'s logged work a call x the traced
    calls) / (the device seconds of its traced `groups`, one a launch of
    the work). None where the trace holds none of its launches, or where
    their number is not the logged launches times the calls (the program
    took another route than the reference: nothing comparable to read)."""
    work = [w for w in ctx.work if w[0] == kernel]
    if not groups or not work:
        return None
    if len(groups) != len(work) * ctx.calls:
        print(f"{kernel}: {len(groups)} traced launches against {len(work)} a call in the "
              f"reference over {ctx.calls} calls; not read", file=sys.stderr)
        return None
    bound = sum(w[3] for w in work) * ctx.calls
    return 100.0 * bound / sum(a.dur for g in groups for a in g)
