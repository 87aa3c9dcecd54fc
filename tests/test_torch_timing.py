"""The port's timing arithmetic (`gimmvfi_tpu_torch/utils/timing.py`), on
the CPU: how a profiler trace's averaged events become a device time per
call, and the bound. The traces themselves exist only on the card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from gimmvfi_tpu_torch.utils.timing import (
    H100_F32_FLOPS,
    bound_ms,
    fmt_ms,
    fmt_share,
    kernel_row,
    per_call_ms,
)


def _event(key, device_type, count, total_us):
    return SimpleNamespace(key=key, device_type=device_type, count=count,
                           self_device_time_total=total_us)


def test_per_call_ms_counts_device_rows_once():
    events = [
        _event("aten::copy_", DeviceType.CPU, 10, 50.0),  # repeats its kernel's row
        _event("copy_kernel", DeviceType.CUDA, 10, 50.0),
        _event("conv_kernel", DeviceType.CUDA, 10, 14000.0),
        _event("idle", DeviceType.CUDA, 0, 0.0),
    ]
    assert per_call_ms(events, iters=10) == pytest.approx({"copy_kernel": 0.005,
                                                           "conv_kernel": 1.4})


def test_per_call_ms_survives_dropped_records():
    """A trace that lost one of ten launches still gives the launch's own
    time, not nine tenths of it; a kernel launched twice a call counts twice."""
    events = [
        _event("conv_kernel", DeviceType.CUDA, 9, 9 * 1400.0),
        _event("twice", DeviceType.CUDA, 19, 19 * 3.0),
    ]
    assert per_call_ms(events, iters=10) == pytest.approx({"conv_kernel": 1.4,
                                                           "twice": 0.006})


def test_bound_and_format():
    ms, by = bound_ms(3.35e9, 989e9)  # 1 ms of bytes, 1 ms of operations
    assert by in ("bytes", "operations") and ms == pytest.approx(1.0)
    assert bound_ms(0.0, 989e12)[1] == "operations"
    assert fmt_ms(None) == "none in the trace"
    assert fmt_ms(1.23456, 2) == "1.23 ms"


def test_float32_bound_takes_the_cuda_core_peak():
    """67 TFLOP/s for float32 outside the tensor cores (H100 SXM data
    sheet): the same operations bound 989 / 67 times later than in bf16."""
    assert H100_F32_FLOPS == 67e12
    assert bound_ms(0.0, 67e9, H100_F32_FLOPS) == (pytest.approx(1.0), "operations")
    ms, by = bound_ms(3.35e9 / 2, 67e9, H100_F32_FLOPS)  # 0.5 ms of bytes, 1 ms of ops
    assert by == "operations" and ms == pytest.approx(1.0)
    assert bound_ms(3.35e9, 67e9)[1] == "bytes"  # at the bf16 peak the bytes bound it


def test_kernel_row_of_a_trace_with_and_without_device_rows():
    """A kernel's one row is its time; a trace in which the profiler
    recorded no device activity gives None, not a failure; two rows that
    match are an error."""
    by_name = per_call_ms([_event("void splat_sum_kernel<4>", DeviceType.CUDA, 10, 1800.0),
                           _event("fill_kernel", DeviceType.CUDA, 10, 30.0)], iters=10)
    assert kernel_row(by_name, "splat_sum_kernel") == pytest.approx(0.18)
    assert kernel_row(by_name, "windowed_corr_kernel") is None
    assert kernel_row(per_call_ms([_event("aten::empty", DeviceType.CPU, 10, 0.0)], 10),
                      "splat_sum_kernel") is None
    with pytest.raises(AssertionError, match="several"):
        kernel_row({"a_kernel<1>": 1.0, "a_kernel<2>": 2.0}, "a_kernel")


def test_fmt_share():
    assert fmt_share(0.5, 2.0) == "25.0% of bound"
    assert fmt_share(0.5, None) == "not measured"
