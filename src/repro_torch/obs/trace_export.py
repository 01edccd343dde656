"""Chrome/Perfetto trace-event export for the event-granular simulator
(port of `repro/obs/trace_export.py`, plain Python as there).

The scheduler feeds a `TraceCollector` while it drains the heap (one
call per probe site, virtual-time stamps); `export_chrome_trace` turns
the collected records into the Trace Event JSON the Chrome tracing UI
and https://ui.perfetto.dev load directly (DESIGN.md §11):

  - one TRACK per client (pid 1, tid = client + 1, named via "M"
    thread_name metadata) carrying "X" slices for trained / recv /
    select / digest / resend;
  - FLOW events ("s" -> "f") linking every in-flight message's send
    slice to its arrival track, so a model's multi-hop dissemination
    renders as connected arrows across client tracks;
  - COUNTER tracks ("C") for bytes-on-wire, dissemination coverage,
    and transport inbox depth.

Timestamps: trace `ts` is microseconds; virtual seconds are scaled by
1e6, so one virtual second reads as one millisecond-free "1s" unit in
the UI (`displayTimeUnit: "ms"`).

Collection is event-backend-only: `ObsSpec.trace=True` with any other
backend, or in sync mode, is rejected at build time.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import json_ready

_US = 1e6  # virtual seconds -> trace microseconds
_PID = 1


class TraceCollector:
    """Accumulates typed trace records with virtual-time stamps.

    `resolution` decimates COUNTER samples only (one per bucket of
    virtual time); slices and flows are kept verbatim — they are the
    trace's payload, and trace collection is opt-in per spec."""

    def __init__(self, resolution: float = 0.0):
        self.resolution = float(resolution)
        self.slices: list = []    # (track, name, t0, t1, cat, args)
        self.flows: list = []     # (src, dst, name, t0, t1)
        self.counters: list = []  # (name, t, value)
        self._counter_last: dict = {}

    def __len__(self) -> int:
        return len(self.slices) + len(self.flows) + len(self.counters)

    def slice(self, track: int, name: str, t0: float, t1: float,
              cat: str = "sim", args: Optional[dict] = None) -> None:
        self.slices.append((int(track), name, float(t0), float(t1), cat,
                            args))

    def flow(self, src: int, dst: int, name: str, t0: float,
             t1: float) -> None:
        """A message in flight src -> dst: renders as a "send" slice on
        the source track plus an s->f arrow to whatever slice sits at
        the arrival time on the destination track (the scheduler's recv
        slice)."""
        self.flows.append((int(src), int(dst), name, float(t0),
                           float(t1)))

    def counter(self, name: str, t: float, value: float) -> None:
        last = self._counter_last.get(name)
        if last is not None and t - last < self.resolution:
            return
        self._counter_last[name] = t
        self.counters.append((name, float(t), float(value)))


def export_chrome_trace(tc: TraceCollector,
                        n_clients: Optional[int] = None,
                        meta: Optional[dict] = None) -> dict:
    """Render the collected records as a Trace Event JSON dict
    (`{"traceEvents": [...]}`), loadable by chrome://tracing and
    ui.perfetto.dev."""
    tracks = {s[0] for s in tc.slices}
    tracks.update(f[0] for f in tc.flows)
    tracks.update(f[1] for f in tc.flows)
    if n_clients is not None:
        tracks.update(range(n_clients))
    evs: list = [{"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
                  "args": {"name": "fedpae fleet"}}]
    for c in sorted(tracks):
        evs.append({"ph": "M", "pid": _PID, "tid": c + 1,
                    "name": "thread_name", "args": {"name": f"client {c}"}})
        evs.append({"ph": "M", "pid": _PID, "tid": c + 1,
                    "name": "thread_sort_index", "args": {"sort_index": c}})
    for track, name, t0, t1, cat, args in tc.slices:
        ev = {"ph": "X", "pid": _PID, "tid": track + 1, "ts": t0 * _US,
              "dur": max(0.0, (t1 - t0) * _US), "name": name, "cat": cat}
        if args:
            ev["args"] = json_ready(args)
        evs.append(ev)
    for fid, (src, dst, name, t0, t1) in enumerate(tc.flows):
        # the flow binds to an enclosing slice at each end: emit the
        # send slice here; the arrival end binds to the scheduler's own
        # recv/digest slice at exactly (dst track, t1)
        evs.append({"ph": "X", "pid": _PID, "tid": src + 1, "ts": t0 * _US,
                    "dur": 0.0, "name": f"send {name}", "cat": "net"})
        evs.append({"ph": "s", "pid": _PID, "tid": src + 1, "ts": t0 * _US,
                    "id": fid, "name": name, "cat": "net"})
        evs.append({"ph": "f", "pid": _PID, "tid": dst + 1, "ts": t1 * _US,
                    "id": fid, "name": name, "cat": "net", "bp": "e"})
    for name, t, value in tc.counters:
        evs.append({"ph": "C", "pid": _PID, "tid": 0, "ts": t * _US,
                    "name": name, "args": {"value": value}})
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "otherData": json_ready(meta or {})}
