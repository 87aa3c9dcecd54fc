"""One run of one cell: set-up, the measured window, the correctness check,
and with `trace` the per-layer metrics of a traced stretch.

The window is closed loop on one stream: call k starts when call k - 1 has
returned its frames to the host, and new calls start until `seconds` have
passed. `frames_per_s` is every frame returned over the window's whole
length (to the end of its last call); `pair_ms_p90` the 90th percentile of
the calls' host-clock times; `peak_mib` the allocator's peak over the
window; `setup_s` from process start to the window's start.

After the window the program is freed and the reference runs on a sample
of the window's calls, drawn from the seed (a reservoir, so the sample is
uniform over however many calls the window made), in float32 and at the
configuration's stated precision: each call's frames and flows are
compared (`drivers/<name>.py: compare`) and held to the cell's limits.
"""

from __future__ import annotations

import math
import random
import statistics
import time
from dataclasses import dataclass, field

import torch

from . import flops
from .spec import Cell, plugin
from .trace import read_profile


@dataclass
class Traced:
    """What the per-layer readers get (`metrics/<name>.py: read(ctx)`)."""

    cell: Cell
    view: object  # trace.TraceView of the traced calls
    host_s: list  # host-clock seconds of each traced call
    calls: int
    flops_per_call: int = 0
    work: list = field(default_factory=list)  # flops.count's log for one call


def p90(values: list) -> float:
    """The 90th percentile (`statistics.quantiles`, n=10, exclusive)."""
    return statistics.quantiles(values, n=10)[-1] if len(values) > 1 else values[0]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
             control: bool = False, fault=None) -> dict:
    """Run `cell` once; returns the result line's object. `control` puts
    the control in the program's place; `fault(out, k)`, when given,
    alters call k's output where it is produced (the harness's tests)."""
    torch.backends.cudnn.allow_tf32 = False  # as the video CLI's main sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    traffic = cell.traffic
    mod = plugin("drivers", traffic["driver"])
    driver = mod.Driver(cell, seed, dev, control=control)
    driver.setup()
    if trace:
        warm_profiler(cuda)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    rng = random.Random(seed)
    keep, want = [], traffic["check_calls"]
    lat, produced = [], 0
    skip, n_traced = traffic["trace_skip"], traffic["trace_calls"]
    prof, traced_s = None, []
    k = 0
    start = time.perf_counter()
    while True:
        if trace and k == skip:
            prof = start_profiler(cuda)
        t1 = time.perf_counter()
        if prof is not None and k < skip + n_traced:
            with torch.profiler.record_function("pair"):
                out = driver.call(k)
        else:
            out = driver.call(k)
        t2 = time.perf_counter()
        if fault is not None:
            out = fault(out, k)
        if prof is not None and k < skip + n_traced:
            traced_s.append(t2 - t1)
            if k == skip + n_traced - 1:
                prof.__exit__(None, None, None)
        lat.append(t2 - t1)
        produced += driver.produced(out)
        if len(keep) < want:  # reservoir sample of the calls to check
            keep.append((k, out))
        else:
            j = rng.randrange(k + 1)
            if j < want:
                keep[j] = (k, out)
        k += 1
        if t2 - start >= seconds and (not trace or k >= skip + n_traced):
            break
    window_s = t2 - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    driver.release()

    result = {"correct": None, "attempted": k, "failed": 0, "metrics": {}, "device": {}}
    ref, base = driver.reference(), driver.reference(stated=True)
    traced = None
    if trace:
        traced = Traced(cell, read_profile(prof), traced_s, n_traced)
        traced.flops_per_call, traced.work = flops.count_call(driver, ref, skip)
    readings = {name: [] for name in cell.limits}
    for kk, out in sorted(keep, key=lambda x: x[0]):
        got = mod.compare(out, driver.expected(ref, kk), driver.expected(base, kk))
        for name in cell.limits:
            readings[name].append(got[name])
        result["failed"] += not all(got[n] <= cell.limits[n] for n in cell.limits)
    del ref, base
    checks = {name: {"value": worst(v), "limit": cell.limits[name]} for name, v in readings.items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        for m in cell.per_layer:
            v = plugin("metrics", m["name"]).read(traced)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"frames_per_s": produced / window_s, "pair_ms_p90": p90(lat) * 1e3,
                  "peak_mib": peak / 2**20, "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["device"] = device_record(dev, cell.chips, peak)
    if trace:
        result["device"]["busy_s"] = traced.view.busy_s()
        result["device"]["window_s"] = traced.view.window_s()
        result["breakdown"] = {"device_ops": traced.view.device_ops(),
                               "idle_gaps": traced.view.idle_gaps()}
    result["window"] = {"seconds": window_s, "calls": k, "frames": produced}
    result["checks"] = checks
    return result


def worst(values: list) -> float:
    """The largest reading, NaN if any is NaN (a NaN never passes)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def device_record(dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": peak}


def start_profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def warm_profiler(cuda: bool):
    """One empty profiling session in set-up, so that the tracer's first
    start does not land inside the window."""
    prof = start_profiler(cuda)
    torch.zeros(8, device="cuda" if cuda else "cpu").add_(1)
    prof.__exit__(None, None, None)
