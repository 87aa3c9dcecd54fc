"""The work of one call, counted over the benchmark's own reference.

The rules of the port's `bench.count_flops`, copied: `FlopCounterMode`
counts the products of convolutions and matmuls, two FLOPs a multiply-add;
elementwise work, resizes, pooling, bilinear sampling (gathers) and the
splat count nothing. A windowed correlation lookup is charged its dots
(a work module with `CHARGED`: `work/windowed_corr.py`) and its own ops
run outside the counter. Counting the reference and not the program keeps the number the
same whatever implements the work.

Beside the count, every call of a reference op that a `work/<kernel>.py`
names (`REFERENCE_OP`) is logged with that kernel's work on the call's
arguments: the rooflines' bounds.
"""

from __future__ import annotations

import importlib
import pkgutil

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import work as work_pkg

def work_modules() -> dict:
    """{kernel: module} of every `work/<kernel>.py`."""
    return {m.name: importlib.import_module(f"{work_pkg.__name__}.{m.name}")
            for m in pkgutil.iter_modules(work_pkg.__path__)}


def count(fn) -> tuple[int, list]:
    """Run `fn()` once; return (its FLOPs, [(kernel, bytes, operations,
    bound seconds)] for each logged op call)."""
    counter = FlopCounterMode(display=False)
    log = []
    patched = []
    for kernel, mod in work_modules().items():
        path, name = mod.REFERENCE_OP.split(":")
        owner = importlib.import_module(path)
        original = getattr(owner, name)

        def logged(*args, _orig=original, _mod=mod, _kernel=kernel, **kwargs):
            w = _mod.work(*args, **kwargs)
            log.append((_kernel, *w))
            if not getattr(_mod, "CHARGED", False):
                return _orig(*args, **kwargs)
            # charged its operations; its own formulation is not counted
            counter.flop_counts["Global"][_kernel] += w[1]
            registry, counter.flop_registry = counter.flop_registry, {}
            try:
                return _orig(*args, **kwargs)
            finally:
                counter.flop_registry = registry

        setattr(owner, name, logged)
        patched.append((owner, name, original))
    try:
        with counter:
            fn()
    finally:
        for owner, name, original in patched:
            setattr(owner, name, original)
    flops = sum(counter.get_flop_counts().get("Global", {}).values())
    return int(flops), log


def count_call(driver, ref, k: int) -> tuple[int, list]:
    """`count` of the reference's call k (the window's inputs for call k)."""
    with torch.no_grad():
        return count(lambda: driver.expected(ref, k))
