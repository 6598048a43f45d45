"""The device's side of a traced run: torch.profiler over the window.

The set-up is runtime/metrics.device_trace's (the CPU and CUDA activities,
a Chrome trace written on exit), copied so that the yardstick does not
move with the program.  A user annotation spans the window; its start in
the trace's clock and the host clock's reading beside it put every device
operation on the host clock, where the spans are.  Device time counts
kernels, copies and memsets; a trace without any (a run on the CPU) has
no device time, and the metrics that read it read nothing."""

import json
import os
import time
from contextlib import contextmanager

from .spans import union

MARK = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class DeviceTrace:
    def __init__(self):
        self.ops = []  # (name, start s, end s, category) on the host clock

    def load(self, path: str, host_start: float) -> None:
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events)
        marks = [e for e in events if e.get("name") == MARK
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace holds no {MARK} annotation")
        offset = float(marks[0]["ts"]) / 1e6 - host_start
        self.ops = [(e["name"], float(e["ts"]) / 1e6 - offset,
                     (float(e["ts"]) + float(e.get("dur", 0))) / 1e6 - offset,
                     e["cat"])
                    for e in events if e.get("cat") in DEVICE_CATS
                    and e.get("ph") == "X"]

    def busy(self, lo: float, hi: float, cats=DEVICE_CATS) -> float:
        """Seconds of [lo, hi] in which an operation of `cats` ran on the
        device."""
        return union([(a, b) for _, a, b, c in self.ops if c in cats], lo, hi)

    def seconds(self, match: str) -> float:
        """Summed time of the operations whose name holds `match`."""
        return sum(b - a for n, a, b, _ in self.ops if match in n)

    def top_ops(self) -> list:
        by = {}
        for n, a, b, _ in self.ops:
            by[n] = by.get(n, 0.0) + (b - a)
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda r: -r[1])[:TOP]

    def gaps(self, lo: float, hi: float) -> list:
        """The idle intervals of [lo, hi], longest first."""
        out, end = [], lo
        for _, a, b, _ in sorted(self.ops, key=lambda o: o[1]):
            if a > end:
                out.append((end, min(a, hi)))
            end = max(end, b)
            if end >= hi:
                break
        if end < hi:
            out.append((end, hi))
        return sorted((g for g in out if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])


def idle_gaps(trace: DeviceTrace, spans, lo: float, hi: float) -> list:
    """The TOP longest idle gaps of [lo, hi], each named by the innermost
    host span open at its middle (the one that started last), or
    "between ops"."""
    out = []
    for a, b in trace.gaps(lo, hi)[:TOP]:
        mid = (a + b) / 2
        open_ = [(s, n) for n, _, s, e in spans.records if s <= mid <= e]
        out.append([max(open_)[1] if open_ else "between ops", b - a])
    return out


@contextmanager
def window(enabled: bool, workdir: str):
    """Profile the block when `enabled`; yields the DeviceTrace (filled on
    exit) or None."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    found = DeviceTrace()
    with profile(activities=activities) as prof:
        with record_function(MARK):
            start = time.perf_counter()
            yield found
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        found.load(path, start)
    finally:
        os.remove(path)
