"""The program's own spans (`repro_torch.obs.spans`), as the per-layer
metrics read them: the traced stretch's roots, one per traced scoring
call (`serve.call`) or training step (`train.step`), taken from the
span store the program keeps in memory. Spans fire only while the
profiler records, so the store's last roots are the traced stretch's.
Every reading is None where the run has no trace, where the store holds
fewer roots than the traced calls or steps, where a device reading is
asked of a run without CUDA events (the CPU), and where the program has
no span store (a port without `obs/spans.py`).

The train phases are read as shares of the step's host time: the
profiler slows every op, and by a factor that varies with the host, so
a traced phase's ms differ by up to twice from one machine to the next
while its share of the step holds."""
from __future__ import annotations

import statistics


def traced_roots(run: dict, name: str, n: int):
    """The store's last `n` roots `name`; None where there are none to
    read."""
    if not run.get("trace") or not n:
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans.roots(name, n)


def _children(roots, child: str, key: str):
    vals = [c[key] for r in roots for c in r["children"]
            if c["name"] == child]
    return None if not vals or None in vals else vals


def median_prefill_device_ms(run: dict):
    """The median device ms of one member's prefill (`serve.prefill`)
    over the traced calls (`serve.call`) and their members."""
    roots = traced_roots(run, "serve.call", len(run.get("calls") or ()))
    vals = roots and _children(roots, "serve.prefill", "device_ms")
    return statistics.median(vals) if vals else None


def step_share(run: dict, child: str):
    """The share, in %, of the traced steps' host time (`train.step`)
    that their `child` spans take."""
    roots = traced_roots(run, "train.step", run.get("steps"))
    vals = roots and _children(roots, child, "host_ms")
    if not vals:
        return None
    return 100.0 * sum(vals) / sum(r["host_ms"] for r in roots)
