"""The sorted splat (`ops/softsplat.py: splat_sum` → `csrc/softsplat_sorted.cu`):
its bound (`work/softsplat_sorted.py`) over the device time of a call's
kernels: the keys kernel, the kernels of `torch.sort` launched after it,
and the gather, found in launch order from the keys kernel's name to the
gather's."""

from ._common import kernel_roofline_pct

FIRST, LAST = "splat_sorted_keys_kernel", "splat_sorted_gather_kernel"


def read(ctx):
    groups, cur = [], None
    for a in sorted((a for a in ctx.view.device if a.launch is not None), key=lambda a: a.launch):
        if FIRST in a.name:
            cur = [a]
        elif cur is not None:
            cur.append(a)
            if LAST in a.name:
                groups.append(cur)
                cur = None
    return kernel_roofline_pct(ctx, "softsplat_sorted", groups)
