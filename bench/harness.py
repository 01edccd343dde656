"""What every run shares: finding a cell and its files by name, the
set-up clock, the device record, the per-layer readers, the check that
no JAX module was loaded, and the result line.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<mix>.json`); its
own data (ensemble size, what is checked, the limits of `correct`) is
`cells/<cell>.json`; the mix's `kind` names its driver
(`drivers/<kind>.py`); each per-layer metric is read by
`metrics/<metric>.py`; the configuration's `as_run["equations"]` names
its model family (`families/<equations>.py`). A later cell, mix,
configuration, family or metric is a new file under those names and
needs no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


def check_name(name: str, what: str = "name") -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a name: up to 64 of "
                         "A-Z a-z 0-9 _ . -, not starting with . or -")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"unit {unit!r}: 1 to 16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """BENCHMARK.json, with every name and unit checked."""
    b = _json(root / "BENCHMARK.json")
    for c in b["configs"]:
        check_name(c["name"], "config")
        for k in c["reduced"]:
            check_name(k, "reduced key")
    for w in b["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], "config")
        check_name(w["traffic"], "traffic")
    for m in b["end_to_end"] + b["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"])
    return b


class Cell:
    """One workload of BENCHMARK.json with its files loaded by name."""

    def __init__(self, name: str, root: Path = ROOT):
        self.bench = benchmark(root)
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = self.entry["chips"]
        self.config = _json(BENCH / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(BENCH / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.data = _json(BENCH / "cells" / f"{name}.json")
        self.arch = self.config["as_run"]
        self.kind = self.traffic["kind"]

    def metrics(self, section: str) -> list:
        """The metrics of `section` ("end_to_end" or "per_layer") this
        cell reports."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]

    def driver(self):
        return load(BENCH / "drivers" / f"{self.kind}.py",
                    f"bench_driver_{self.kind}")


def load(path: Path, modname: str):
    """Import a file of the benchmark by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_layer_metric(name: str, run: dict):
    """metrics/<name>.py's `read(run)`: a number, or None where the run
    holds nothing for it to read."""
    path = BENCH / "metrics" / f"{name}.py"
    return load(path, "bench_metric_" + re.sub(r"\W", "_", name)).read(run)


def process_start() -> float:
    """The process's start on the `time.time()` clock (from /proc), or
    now where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def loaded_jax() -> list:
    """Modules whose top-level name is JAX's, its libraries' or the JAX
    package's (`repro`; `repro_torch` is another name)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in JAX_NAMES})


def device_record(torch, chips: int) -> dict:
    """`device` of the result line: the card's name, the cards used, the
    peak allocation on the fullest (after `reset_peak_memory_stats` at
    the start)."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips)) \
        if torch.cuda.is_available() else 0
    return {"platform": "gpu" if torch.cuda.is_available() else "cpu",
            "kind": torch.cuda.get_device_name(0)
            if torch.cuda.is_available() else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    """The last line of standard output; `checks` (each number compared,
    with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r} "
                     f"({'ok' if v['ok'] else 'FAILED'})"
                     for k, v in checks.items())
