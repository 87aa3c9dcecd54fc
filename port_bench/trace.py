"""What a `--trace 1` run reads from `torch.profiler`'s trace of a steady
stretch of its window.

The harness wraps each traced call in a span `pair`; the program's own
spans (`prepare`, `decode_one` in `interpolate_sequential`) sit inside.
A device activity (kernel, copy, fill) belongs to the host span in which
it was launched (the runtime call with its correlation id). The traced
window runs from the first `pair` span's start to the last one's end.
"""

from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class Activity:
    name: str
    start: float  # seconds, the trace's clock
    dur: float
    launch: float | None  # the launching runtime call's start


@dataclass
class TraceView:
    device: list  # Activity, by start
    spans: dict  # name -> [(start, end)] of host annotations
    host: list = field(default_factory=list)  # (start, end, name) of host events

    @property
    def window(self) -> tuple[float, float]:
        pairs = self.spans.get("pair", [])
        return min(s for s, _ in pairs), max(e for _, e in pairs)

    def launched_in(self, name: str) -> list[list[Activity]]:
        """For each span `name`, the device activities launched inside it."""
        out = []
        for s, e in self.spans.get(name, []):
            out.append([a for a in self.device if a.launch is not None and s <= a.launch <= e])
        return out

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device activity, clipped to the window."""
        lo, hi = self.window
        merged = []
        for a in sorted(self.device, key=lambda a: a.start):
            s, e = max(a.start, lo), min(a.start + a.dur, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches of the window with nothing on the device,
        each named by the innermost host event running at its start."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host]
        named = []
        for s, e in gaps[:top]:
            name = "none"
            for i in range(bisect_right(starts, s) - 1, -1, -1):
                hs, he, hn = self.host[i]
                if he >= s:
                    name = hn
                    break
            named.append([name, e - s])
        return named

    def device_ops(self, top: int = 10) -> list:
        """Device time by activity name inside the window, largest first."""
        lo, hi = self.window
        total = {}
        for a in self.device:
            if lo <= a.start <= hi:
                total[a.name] = total.get(a.name, 0.0) + a.dur
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def parse(events: list) -> TraceView:
    """A `TraceView` of Chrome-trace `events` (times in microseconds)."""
    launches = {}
    device, spans, host = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        start, dur = ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = start
        if cat in HOST_CATS:
            host.append((start, start + dur, ev["name"]))
        if cat == "user_annotation":
            spans.setdefault(ev["name"], []).append((start, start + dur))
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            corr = ev.get("args", {}).get("correlation")
            device.append(Activity(ev["name"], ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6,
                                   launches.get(corr)))
    device.sort(key=lambda a: a.start)
    host.sort()
    for v in spans.values():
        v.sort()
    return TraceView(device, spans, host)


def read_profile(prof) -> TraceView:
    """Export a finished `torch.profiler.profile` to a file under TMPDIR,
    read it and delete it."""
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)
