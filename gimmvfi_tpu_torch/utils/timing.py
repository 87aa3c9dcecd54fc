"""Time work on the CUDA card with CUDA events."""

from __future__ import annotations

import statistics

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 peak, H100 SXM data sheet


def cuda_ms(fn, iters=20, warmup=1) -> float:
    """Median ms of fn() over `iters` runs, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the HBM
    rate and bf16 operations over the tensor-core peak, and which bounds it."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / H100_BF16_FLOPS * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")
