"""OBS-PARITY: code/doc drift check for the metric namespace.

The observability contract is that DESIGN.md §11 documents the FULL
metric namespace, and the parity tier can diff whole frames because
names are stable. This project rule machine-checks the doc half: it
extracts every metric-name literal the instrumented code emits (the
first string argument of ``.inc`` / ``.set`` / ``.observe`` /
``.stopwatch`` calls in any scanned file, plus dotted-name string
literals inside ``obs/probes.py``'s name/value tuple tables) and cross-
checks the set against the §11 namespace table in DESIGN.md — failing in
BOTH directions: an emitted name missing from the table, and a
documented name no code emits.

The doc side is the first markdown table under the heading containing
"§11" whose header row has a ``metric`` column; the base name is its
first cell with any ``{label=...}`` qualifier stripped. Keeping the
table parseable is part of the contract.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.registry import Rule, rule

# a metric name: at least two dotted lowercase segments
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")
_EMIT_METHODS = {"inc", "set", "observe", "stopwatch"}
# string literals that look dotted but are file names, not metrics
_NOT_METRICS_SUFFIXES = (".json", ".csv", ".png", ".py", ".md")

_TABLE_ROW_RE = re.compile(r"^\s*\|\s*`([^`]+)`")


def is_metric_name(s: str) -> bool:
    return bool(METRIC_NAME_RE.match(s)) \
        and not s.endswith(_NOT_METRICS_SUFFIXES)


def emitted_metrics(ctx) -> Dict[str, int]:
    """name -> first emission line for one FileContext. Emission sites
    are `<recv>.inc("name", ...)` (and set/observe/stopwatch); in
    obs/probes.py, `("name", value)` tuple tables count too — the
    CompiledProbe loops over those before calling inc."""
    out: Dict[str, int] = {}
    scan_tuples = ctx.rel.endswith("obs/probes.py")
    for node in ctx.nodes:
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _EMIT_METHODS and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and is_metric_name(a.value):
                out.setdefault(a.value, node.lineno)
        elif scan_tuples and isinstance(node, ast.Tuple) and node.elts:
            a = node.elts[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and is_metric_name(a.value):
                out.setdefault(a.value, node.lineno)
    return out


def doc_metrics(design_text: str) -> Dict[str, int]:
    """Base metric names from the DESIGN.md §11 namespace table:
    name -> line (1-based). Empty when the section or table is
    missing — the rule reports that explicitly."""
    out: Dict[str, int] = {}
    in_section = in_table = False
    for i, line in enumerate(design_text.splitlines(), start=1):
        if line.startswith("#") and "§" in line:
            sec = line.split("§", 1)[1]
            in_section = sec[:2].strip().rstrip(".") == "11"
            continue
        if not in_section:
            continue
        m = _TABLE_ROW_RE.match(line)
        if m is None:
            if in_table and line.strip().startswith("|"):
                continue  # header / separator rows
            in_table = in_table and line.strip().startswith("|")
            continue
        in_table = True
        name = m.group(1).split("{", 1)[0].strip()
        if is_metric_name(name):
            out.setdefault(name, i)
    return out


@rule("OBS-PARITY", kind="project")
class ObsParity(Rule):
    contract = ("every metric name the code emits appears in the "
                "DESIGN.md §11 namespace table, and every documented "
                "name is emitted somewhere — doc/code drift fails")

    def check_project(self, pctx) -> Iterator[Diagnostic]:
        probes = [c for c in pctx.contexts
                  if c.rel.endswith("obs/probes.py")]
        if not probes:
            return  # fixture/partial runs without the obs layer
        design = pctx.design_md
        if design is None:
            yield Diagnostic(
                probes[0].rel, 1, 0, self.id,
                "obs/probes.py is in the scanned set but no DESIGN.md "
                "was found at the project root — the §11 namespace "
                "table is the parity source of truth")
            return
        doc = doc_metrics(design.text)
        if not doc:
            yield Diagnostic(
                design.rel, 1, 0, self.id,
                "DESIGN.md has no parseable §11 namespace table "
                "(| `metric.name` | ... rows under the §11 heading)")
            return
        code: Dict[str, Tuple[str, int]] = {}
        for c in pctx.contexts:
            for name, line in emitted_metrics(c).items():
                code.setdefault(name, (c.rel, line))
        for name in sorted(set(code) - set(doc)):
            rel, line = code[name]
            yield Diagnostic(
                rel, line, 0, self.id,
                f"emitted metric {name!r} is missing from the "
                "DESIGN.md §11 namespace table")
        for name in sorted(set(doc) - set(code)):
            yield Diagnostic(
                design.rel, doc[name], 0, self.id,
                f"documented metric {name!r} is emitted nowhere in "
                "the scanned files — stale doc row")
