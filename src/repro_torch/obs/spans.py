"""Program spans: named, nested intervals of the port's entry layer
(`launch/serve.py::serve_batch`, `launch/steps.py`'s train step), on
only while a profiler records.

    with span("serve.call", device=prompts.device):
        with span("serve.prefill", member=i):
            ...

While no profiler records, `span` returns one shared null context: one
read of `torch.autograd.profiler._is_profiler_enabled` (which
`torch.profiler.profile` and `torch.autograd.profiler.emit_nvtx` set),
no allocation. While one records, a span

- opens `torch.profiler.record_function(name)`: the span lands in the
  profiler's trace as a `user_annotation` event, on the clock of the
  device activity it records, and becomes an NVTX range under
  `emit_nvtx`;
- appends a record to the bounded in-memory `STORE` (the oldest records
  dropped at its cap): name, labels, parent, the id of its root (roots
  are counted; a root's descendants share its id), host start and end
  on the clock of `obs.metrics.Stopwatch`, and, where the root was given
  a CUDA `device`, a pair of CUDA events recorded on that device's
  current stream.

A span never synchronizes the device. `roots(name, n)` reads the last n
closed roots of a name with their descendants, in host and device ms
with their self time (the span's time less its children's); it
synchronizes the device once. A store's spans nest on one thread: the
entry layer opens them on the calling thread (autograd's device thread
opens none).

Span names are not metric names: they never pass through
`obs.metrics.Metrics`, and DESIGN.md §11 describes them apart from its
namespace table.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs.metrics import Stopwatch

CAP = 65536                     # spans a store keeps, the newest
_OFF = contextlib.nullcontext()


class _Rec:
    __slots__ = ("id", "name", "labels", "parent", "root", "device",
                 "t0", "t1", "e0", "e1")


class SpanStore:
    """The records of the spans opened while a profiler recorded, the
    newest `cap` of them."""

    def __init__(self, cap: int = CAP):
        self.spans = collections.deque(maxlen=cap)
        self._clock = Stopwatch().start()
        self._open = []          # the open spans, innermost last
        self._ids = 0
        self._roots = 0

    def open(self, name: str, labels: dict, device) -> _Rec:
        up = self._open[-1] if self._open else None
        r = _Rec()
        self._ids += 1
        r.id, r.name, r.labels = self._ids, name, labels
        if up is None:
            self._roots += 1
            r.parent, r.root = None, self._roots
        else:
            r.parent, r.root = up.id, up.root
            device = up.device if device is None else device
        r.device = device
        r.e0 = r.e1 = r.t1 = None
        if device is not None and device.type == "cuda":
            r.e0 = torch.cuda.Event(enable_timing=True)
            r.e0.record(torch.cuda.current_stream(device))
        self._open.append(r)
        self.spans.append(r)     # at its start: a kept root keeps its spans
        r.t0 = self._clock.peek()
        return r

    def close(self, r: _Rec) -> None:
        r.t1 = self._clock.peek()
        if r.e0 is not None:
            r.e1 = torch.cuda.Event(enable_timing=True)
            r.e1.record(torch.cuda.current_stream(r.device))
        self._open.pop()


STORE = SpanStore()


def span(name: str, device: Optional[torch.device] = None, **labels):
    """A context manager around one span of the entry layer: the shared
    null context while no profiler records. `device` (a root's: its
    children take it) says where the span's work runs; CUDA events time
    it there."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _on(STORE, name, device, labels)


@contextlib.contextmanager
def _on(store: SpanStore, name: str, device, labels: dict):
    with torch.profiler.record_function(name):
        r = store.open(name, labels, device)
        try:
            yield
        finally:
            store.close(r)


def roots(name: str, n: int, store: Optional[SpanStore] = None):
    """The last `n` closed root spans named `name`, oldest first, each a
    dict: name, labels, id, root, host_ms, device_ms (None without CUDA
    events), self_host_ms, self_device_ms and children (the same dicts,
    in order). None when the store holds fewer."""
    store = STORE if store is None else store
    recs = [r for r in store.spans if r.t1 is not None]
    top = [r for r in recs if r.parent is None and r.name == name][-n:]
    if n < 1 or len(top) < n:
        return None
    kept = {r.root for r in top}
    recs = [r for r in recs if r.root in kept]
    if any(r.e1 is not None for r in recs):
        torch.cuda.synchronize()
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)

    def tree(r):
        ch = [tree(c) for c in kids[r.id]]
        host = (r.t1 - r.t0) * 1e3
        dev = r.e0.elapsed_time(r.e1) if r.e1 is not None else None
        return {"name": r.name, "labels": dict(r.labels), "id": r.id,
                "root": r.root, "host_ms": host, "device_ms": dev,
                "self_host_ms": host - sum(c["host_ms"] for c in ch),
                "self_device_ms": None if dev is None else
                dev - sum(c["device_ms"] for c in ch),
                "children": ch}
    return [tree(r) for r in top]
