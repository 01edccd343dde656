"""The port's program spans (`repro_torch.obs.spans`) on the CPU: off,
`span` is one shared null context and records nothing; under a CPU
`torch.profiler.profile` spans nest with the right parent, root id and
labels, reach the exported Chrome trace as `user_annotation` events of
their names, drop the oldest at the store's cap, and the reader returns
the last profiled stretch's roots."""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_threads import one_thread as _one_thread  # noqa: F401
from repro_torch.obs import spans


@pytest.fixture
def store(monkeypatch):
    s = spans.SpanStore()
    monkeypatch.setattr(spans, "STORE", s)
    return s


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _step(i):
    with spans.span("t.root", device=torch.device("cpu"), step=i):
        with spans.span("t.a", part=0):
            torch.ones(4).sum()
        with spans.span("t.b"):
            with spans.span("t.c"):
                torch.ones(4).sum()


def test_off_is_one_shared_null_context(store):
    a, b = spans.span("t.root"), spans.span("t.other", member=1)
    assert a is b
    with a:
        _step(0)
    assert len(store.spans) == 0
    assert spans.roots("t.root", 1, store) is None


def test_nesting_parents_roots_and_labels(store):
    _profiled(lambda: [_step(i) for i in range(2)])
    recs = list(store.spans)
    assert [r.name for r in recs] == ["t.root", "t.a", "t.b", "t.c"] * 2
    by = {r.id: r for r in recs}
    for r in recs:
        if r.name == "t.root":
            assert r.parent is None
        else:
            assert by[r.parent].root == r.root
    assert [r.root for r in recs] == [1] * 4 + [2] * 4
    c = [r for r in recs if r.name == "t.c"][0]
    assert by[c.parent].name == "t.b"
    assert recs[0].labels == {"step": 0} and recs[1].labels == {"part": 0}
    assert all(r.e0 is None and r.e1 is None for r in recs)
    (r0, r1) = spans.roots("t.root", 2, store)
    assert [c["name"] for c in r1["children"]] == ["t.a", "t.b"]
    assert r1["children"][1]["children"][0]["name"] == "t.c"
    assert r1["labels"] == {"step": 1} and r1["device_ms"] is None
    for r in (r0, r1):
        assert r["host_ms"] > 0
        kids = sum(c["host_ms"] for c in r["children"])
        assert r["self_host_ms"] == pytest.approx(r["host_ms"] - kids)
        assert 0 <= r["self_host_ms"] <= r["host_ms"]


def test_spans_reach_the_chrome_trace(store, tmp_path):
    prof = _profiled(lambda: _step(0))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    for n in ("t.root", "t.a", "t.b", "t.c"):
        assert names.count(n) == 1


def test_store_drops_its_oldest_at_its_cap(monkeypatch):
    s = spans.SpanStore(cap=6)
    monkeypatch.setattr(spans, "STORE", s)
    _profiled(lambda: [_step(i) for i in range(3)])
    assert len(s.spans) == 6
    assert [r.root for r in s.spans] == [2, 2, 3, 3, 3, 3]
    # root 2's own record went with root 1's: only root 3 is read
    (r,) = spans.roots("t.root", 1, s)
    assert r["root"] == 3 and len(r["children"]) == 2
    assert spans.roots("t.root", 2, s) is None


def test_reader_takes_the_last_stretch(store):
    _profiled(lambda: [_step(i) for i in range(3)])
    _step(99)                                # off: not recorded
    _profiled(lambda: [_step(i) for i in (10, 11)])
    got = spans.roots("t.root", 2, store)
    assert [r["labels"]["step"] for r in got] == [10, 11]
    assert [r["root"] for r in got] == [4, 5]
    assert len(spans.roots("t.root", 5, store)) == 5
    assert spans.roots("t.root", 6, store) is None
    assert spans.roots("t.a", 1, store) is None      # never a root


def test_open_span_is_not_read(store):
    def inside():
        with spans.span("t.root", step=0):
            assert spans.roots("t.root", 1, store) is None
    _profiled(inside)
    assert len(spans.roots("t.root", 1, store)) == 1
