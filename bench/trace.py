"""The traced run's reading of the device, from `torch.profiler` (CUPTI)
recording host ops and device activity over a traced stretch of the
window, exported as a Chrome trace to the run's temporary directory,
read back and deleted (the profiler keeps no device event when it
records the device alone, as a trial on the H100 showed). From it: the
device's busy seconds (the union of kernel, copy and set intervals
inside the benchmark's WINDOW span), the kernels by name, time and the
CALL span they started in (a driver that syncs at the end of each call
wraps each in one, so that a kernel's launches are told apart by call),
the launches, and the breakdown: device operations by total time, and idle
gaps by the innermost host op running at each gap's middle. Recording
host ops slows the host, so the traced window's idle share is larger
than an untraced window's; rates are taken from the untraced rest of
the window instead (the drivers' `after_trace`).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "bench.window"          # the benchmark's span around the window
CALL = "bench.call"              # a driver's span around one synced call
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
MAX_SCAN = 2000                  # host ops looked back per gap


@contextlib.contextmanager
def traced(torch, enabled: bool, out: dict):
    """Profile the body when `enabled`, inside the WINDOW span, and keep
    the profiler in out["prof"]; `read` it once the run's window has
    closed."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    finally:
        prof.stop()
    out["prof"] = prof


def call_span(enabled: bool):
    """The CALL span around one call of a traced stretch; nothing when
    not traced."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(CALL)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    spans = []
    for s, e in sorted(intervals):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return sum(e - s for s, e in spans), spans


def _device(events, lo=float("-inf"), hi=float("inf"), calls=()):
    dev, kernels = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e["dur"]), hi)
        if t > s:
            dev.append((s, t))
            if e["cat"] == "kernel":
                kernels.append((e["name"], t - s,
                                bisect.bisect_right(calls, s) - 1))
    return dev, kernels


def _host_label(host, starts, t):
    """The innermost host op running at t: the latest-starting one that
    still runs (host ops nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - MAX_SCAN, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host outside any traced op"


def read(tr: dict) -> dict:
    """The reading of a traced stretch (`read_events`)."""
    return read_events(_events(tr.pop("prof")))


def read_events(events: list) -> dict:
    """busy_s, window_s, the kernels [(name, seconds, call)], the
    launches and the breakdown (the ten device ops of most time; the ten
    labels of most idle time) of an exported trace's events. `call` is
    the index of the last CALL span that started before the kernel, -1
    before the first."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") in HOST_CATS]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    calls = sorted(float(e["ts"]) for e in events if e.get("name") == CALL
                   and e.get("cat") in HOST_CATS)
    dev, kernels = _device(events, w0, w1, calls)
    busy, spans = _union(dev)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") not in (WINDOW, CALL))
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    prev = w0
    for s, e in spans + [[w1, w1]]:
        if s > prev:
            idle[_host_label(host, starts, (prev + s) / 2)] += \
                (s - prev) * 1e-6
        prev = max(prev, e)
    ops = defaultdict(float)
    for name, dur, _ in kernels:
        ops[name[:160]] += dur * 1e-6

    def top(d):
        return [[n, v] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": [(n, d * 1e-6, c) for n, d, c in kernels],
            "launches": len(kernels),
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def kernel_seconds(trace: dict, pattern) -> tuple:
    """(seconds, launches) of the traced kernels whose name matches the
    compiled regex `pattern`."""
    hits = [d for n, d, _ in trace["kernels"] if pattern.search(n)]
    return sum(hits), len(hits)


def launch_calls(trace: dict, pattern) -> list:
    """The CALL index of each traced launch of a kernel whose name
    matches `pattern` (-1: before the first CALL span)."""
    return [c for n, _, c in trace["kernels"] if pattern.search(n)]


def launch_counts(trace: dict, pattern) -> dict:
    """{kernel name (its first 80 characters): launches} of the traced
    kernels whose name matches `pattern`."""
    out = defaultdict(int)
    for n, _, _ in trace["kernels"]:
        if pattern.search(n):
            out[n[:80]] += 1
    return dict(out)
