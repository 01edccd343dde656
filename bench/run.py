#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card(s) of this machine:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared for `correct` are also the last
lines of standard error. Exits non-zero, printing no result, without
CUDA or with fewer cards than the cell asks for, when the port cannot be
imported, or when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Ctx:
    """One run: its arguments, the set-up clock, the device record and
    the checks, handed to the cell's driver."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 smoke=False, log=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.smoke = trace, device, smoke
        self.t_start = t_start
        self.setup_s = None
        self.device_rec = None
        self._log = log or (lambda s: print(s, file=sys.stderr, flush=True))

    def log(self, s: str):
        self._log(s)

    def setup_done(self):
        self.setup_s = time.time() - self.t_start

    def record_device(self):
        """Read the peak memory: called once the window has closed, before
        the reference runs."""
        import torch

        from bench import harness
        self.device_rec = harness.device_record(
            torch, self.cell.chips if self.device.type == "cuda" else 1)

    def check(self, name: str, value: float) -> dict:
        limit = self.cell.data["check"]["limits"][name]
        return {"value": value, "limit": limit, "ok": value <= limit}


def run_cell(name, seed, seconds, trace, device, t_start, smoke=False,
             root=ROOT, log=None) -> dict:
    """Drive one run of cell `name` on `device` and return the result's
    pieces: correct, attempted, failed, metrics, device, checks and, when
    traced, breakdown. The CPU tests call it with `smoke` (the port's
    smoke widths, short lengths) on the CPU."""
    from bench import harness
    cell = harness.Cell(name, root)
    ctx = Ctx(cell, seed, seconds, trace, device, t_start, smoke, log)
    out = cell.driver().run(ctx)
    checks = out["checks"]
    if trace:
        metrics = {}
        for m in cell.metrics("per_layer"):
            v = harness.read_layer_metric(m["name"], out["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(out["e2e"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    dev = dict(ctx.device_rec)
    tr = out["layer"].get("trace")
    if trace and tr:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    return {"correct": all(c["ok"] for c in checks.values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev, "checks": checks,
            "breakdown": tr["breakdown"] if trace and tr else None}


def main(argv=None) -> int:
    from bench import harness
    t_start = harness.process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = harness.Cell(a.workload)
    # the port's kernels build into build/ inside this checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    # the host only draws inputs and dispatches: one intra-op thread
    # keeps idle worker threads off the cores that dispatch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   torch.device("cuda", 0), t_start)
    found = harness.loaded_jax()
    if found:
        print(f"JAX modules loaded in the run's process: {found}",
              file=sys.stderr)
        return 4
    print(harness.checks_text(res["checks"]), file=sys.stderr, flush=True)
    print(harness.result_line(res["correct"], res["attempted"],
                              res["failed"], res["metrics"], res["device"],
                              res["checks"], res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
