"""The port's timing arithmetic (`gimmvfi_tpu_torch/utils/timing.py`), on
the CPU: how a profiler trace's averaged events become a device time per
call, and the bound. The traces themselves exist only on the card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from gimmvfi_tpu_torch.utils.timing import bound_ms, fmt_ms, per_call_ms


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
