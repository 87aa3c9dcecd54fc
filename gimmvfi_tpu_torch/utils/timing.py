"""Time work on the CUDA card: CUDA events around each call (`cuda_ms`),
or the device's own time from a `torch.profiler` trace (`device_ms`,
`kernel_row`); the launch floor (`launch_floor_ms`) and the bound
(`bound_ms`). A profiler may record no device activity at all; the trace
readings are then None ("not measured") and only the events' times stand."""

from __future__ import annotations

import ctypes
import statistics

import torch
from torch.autograd import DeviceType

from .kernel_build import build_text

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
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


def device_ms(fn, iters=10, warmup=1) -> tuple[float | None, dict[str, float]]:
    """fn()'s own device time per call from `torch.profiler` (CPU and CUDA
    activities): the kernels, copies and sets its `iters` calls ran on the
    card, by name (`per_call_ms`) and summed over names. Unlike `cuda_ms` it
    leaves out the host's work between launches. Returns (ms per call,
    {name: ms per call}); None when the trace holds no device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = per_call_ms(prof.key_averages(), iters)
    total = sum(by_name.values())
    return (total if total > 0 else None), by_name


def per_call_ms(events, iters: int) -> dict[str, float]:
    """{name: ms per call} from a trace's averaged events over `iters` calls:
    the device rows only (a host op's device time repeats its kernels'
    rows), each as its mean duration times its launches a call. A trace may
    drop some records, so the launches a call are its recorded count over
    `iters`, rounded, and at least 1; the mean is over what was recorded."""
    by_name = {}
    for ev in events:
        if ev.device_type != DeviceType.CUDA or ev.count == 0 or ev.self_device_time_total <= 0:
            continue
        per_launch = ev.self_device_time_total / ev.count / 1e3
        by_name[ev.key] = per_launch * max(1, round(ev.count / iters))
    return by_name


def kernel_row(by_name: dict[str, float], kernel: str) -> float | None:
    """A kernel's own ms per call from a `device_ms` reading: the one row
    whose name holds `kernel`, or None where the trace holds no such row.
    Raises if several rows match."""
    rows = [v for k, v in by_name.items() if kernel in k]
    if len(rows) > 1:
        raise AssertionError(f"several {kernel} rows in the trace: {list(by_name)}")
    return rows[0] if rows else None


EMPTY_KERNEL = r"""#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def launch_floor_ms(iters: int = 50) -> float | None:
    """The launch floor: the device time of a kernel of one warp that does
    nothing, from a `torch.profiler` trace; None where the trace holds no
    row for it. It estimates the least time any launch takes, not a strict
    lower bound: a kernel's row may read a little under it."""
    lib, _ = build_text("empty", EMPTY_KERNEL)
    fn = lib.empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        err = fn(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty_launch failed: cudaError {err}")

    _, by_name = device_ms(run, iters=iters)
    return kernel_row(by_name, "empty_kernel")


def fmt_ms(value: float | None, digits: int = 4) -> str:
    """A time in ms for a printed line; `device_ms`'s None as such."""
    return "none in the trace" if value is None else f"{value:.{digits}f} ms"


def fmt_share(bound: float, value: float | None) -> str:
    """A bound's share of a measured time for a printed line, as "x% of
    bound"; "not measured" for `device_ms`'s None."""
    return "not measured" if value is None else f"{100 * bound / value:.1f}% of bound"


def bound_ms(nbytes: float, flops: float = 0.0,
             peak_flops: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak for their type (default bf16 on the
    tensor cores; `H100_TF32_FLOPS` for TF32 on the tensor cores;
    `H100_F32_FLOPS` for float32 on the CUDA cores), and which bounds it."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")
